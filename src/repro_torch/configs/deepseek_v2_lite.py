"""deepseek-v2-lite-16b [moe]: 27L d_model=2048 16H, MLA kv_lora=512,
d_ff_expert=1408, vocab=102400, 2 shared + 64 routed experts top-6;
first layer uses a dense MLP (d_ff=10944).  [arXiv:2405.04434; hf]
Counterpart of ``repro/configs/deepseek_v2_lite.py``.
"""

from repro_torch.models.config import MLAConfig, MoEConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe",
        d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
        d_ff=10944,                              # dense MLP of layer 0
        vocab_size=102400,
        prefix=("global",),                      # dense first layer
        pattern=("global",), repeats=26,         # 27 layers total
        mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                      qk_rope_head_dim=64, v_head_dim=128),
        moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                      num_shared_experts=2),
        moe_in_prefix=False,
        mlp_act="silu", tie_embeddings=False,
        rope_theta=10000.0,
    ).validate()


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-lite-smoke", family="moe",
        d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=160, vocab_size=256,
        prefix=("global",),
        pattern=("global",), repeats=2,
        mla=MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16),
        moe=MoEConfig(num_experts=8, top_k=3, d_ff_expert=48,
                      num_shared_experts=2),
        moe_in_prefix=False,
        mlp_act="silu", tie_embeddings=False,
    ).validate()
