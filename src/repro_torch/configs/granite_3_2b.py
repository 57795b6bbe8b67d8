"""granite-3-2b [dense]: 40L d_model=2048 32H (GQA kv=8) d_ff=8192
vocab=49155 -- GQA.  [hf:ibm-granite/granite-3.0-2b-base; hf]
Counterpart of ``repro/configs/granite_3_2b.py``.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b", family="dense",
        d_model=2048, num_heads=32, num_kv_heads=8, head_dim=64,
        d_ff=8192, vocab_size=49155,
        pattern=("global",), repeats=40,
        mlp_act="silu", tie_embeddings=True,
        rope_theta=10000.0,
    ).validate()


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b-smoke", family="dense",
        d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
        d_ff=128, vocab_size=515,            # deliberately non-power-of-two
        pattern=("global",), repeats=3,
        mlp_act="silu", tie_embeddings=True,
    ).validate()
