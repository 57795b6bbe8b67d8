"""gemma-7b [dense]: 28L d_model=3072 16H (GQA kv=16) d_ff=24576
vocab=256000 -- GeGLU, head_dim=256.  [arXiv:2403.08295; hf]
Counterpart of ``repro/configs/gemma_7b.py``.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b", family="dense",
        d_model=3072, num_heads=16, num_kv_heads=16, head_dim=256,
        d_ff=24576, vocab_size=256000,
        pattern=("global",), repeats=28,
        mlp_act="gelu",
        tie_embeddings=True, scale_embeddings=True,
        rope_theta=10000.0,
    ).validate()


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma-7b-smoke", family="dense",
        d_model=48, num_heads=4, num_kv_heads=4, head_dim=32,  # dh > d/H
        d_ff=192, vocab_size=512,
        pattern=("global",), repeats=2,
        mlp_act="gelu", tie_embeddings=True, scale_embeddings=True,
    ).validate()
