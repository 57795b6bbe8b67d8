"""phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H (GQA kv=8)
d_ff=6400/expert, vocab=32064, MoE 16 experts top-2.
[hf:microsoft/Phi-3.5-MoE-instruct; hf]
Counterpart of ``repro/configs/phi35_moe.py``.
"""

from repro_torch.models.config import MoEConfig, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-42b-a6.6b", family="moe",
        d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
        d_ff=6400, vocab_size=32064,
        pattern=("global",), repeats=32,
        moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=6400),
        mlp_act="silu", tie_embeddings=False,
        rope_theta=10000.0,
    ).validate()


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3.5-moe-smoke", family="moe",
        d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
        d_ff=96, vocab_size=256,
        pattern=("global",), repeats=2,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=96),
        mlp_act="silu", tie_embeddings=False,
    ).validate()
