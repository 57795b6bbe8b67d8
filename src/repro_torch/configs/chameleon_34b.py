"""chameleon-34b [vlm]: 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536 -- early-fusion: images are VQ-VAE tokens in the SAME
vocabulary, so the backbone is a plain token transformer (the VQ tokenizer
is the stubbed frontend).  [arXiv:2405.09818; unverified]
Counterpart of ``repro/configs/chameleon_34b.py``.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b", family="vlm",
        d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
        d_ff=22016, vocab_size=65536,
        pattern=("global",), repeats=48,
        mlp_act="silu", tie_embeddings=False,
        rope_theta=10000.0,
    ).validate()


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="chameleon-34b-smoke", family="vlm",
        d_model=64, num_heads=8, num_kv_heads=2, head_dim=8,
        d_ff=160, vocab_size=512,
        pattern=("global",), repeats=2,
        mlp_act="silu", tie_embeddings=False,
    ).validate()
