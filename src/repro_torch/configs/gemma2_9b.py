"""gemma2-9b [dense]: 42L d_model=3584 16H (GQA kv=8) d_ff=14336
vocab=256000 -- local+global alternating, logit softcaps.
[arXiv:2408.00118; hf]
Counterpart of ``repro/configs/gemma2_9b.py``.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b", family="dense",
        d_model=3584, num_heads=16, num_kv_heads=8, head_dim=256,
        d_ff=14336, vocab_size=256000,
        pattern=("local", "global"), repeats=21,          # 42 layers
        sliding_window=4096,
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        query_scale=224.0 ** -0.5,                         # d_model / heads
        mlp_act="gelu", use_post_norms=True,
        tie_embeddings=True, scale_embeddings=True,
        rope_theta=10000.0,
    ).validate()


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b-smoke", family="dense",
        d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512,
        pattern=("local", "global"), repeats=2,
        sliding_window=8,
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        query_scale=16.0 ** -0.5,
        mlp_act="gelu", use_post_norms=True,
        tie_embeddings=True, scale_embeddings=True,
    ).validate()
