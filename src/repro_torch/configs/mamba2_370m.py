"""mamba2-370m [ssm]: 48L d_model=1024 (attention-free) vocab=50280,
ssm_state=128 -- SSD (state-space duality).  [arXiv:2405.21060; unverified]
Counterpart of ``repro/configs/mamba2_370m.py``.
"""

from repro_torch.models.config import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m", family="ssm",
        d_model=1024, num_heads=1, num_kv_heads=1, head_dim=1,  # attn-free
        d_ff=0, vocab_size=50280,
        pattern=("mamba",), repeats=48,
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk=128),
        tie_embeddings=True,
    ).validate()


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m-smoke", family="ssm",
        d_model=64, num_heads=1, num_kv_heads=1, head_dim=1,
        d_ff=0, vocab_size=256,
        pattern=("mamba",), repeats=3,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                      n_groups=1, chunk=8),
        tie_embeddings=True,
    ).validate()
