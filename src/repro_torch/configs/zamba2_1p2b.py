"""zamba2-1.2b [hybrid]: 38 Mamba2 layers (d_model=2048, ssm_state=64)
+ one weight-SHARED attention+MLP block (32H kv=32, d_ff=8192) applied
every 6 Mamba layers.  vocab=32000.  [arXiv:2411.15242; hf]

Stack: (6x mamba + shared_attn) x 6 + 2x mamba = 38 mamba applications,
6 shared-block applications (one set of attention weights).
Counterpart of ``repro/configs/zamba2_1p2b.py``.
"""

from repro_torch.models.config import ModelConfig, SSMConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b", family="hybrid",
        d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
        d_ff=8192, vocab_size=32000,
        pattern=("mamba",) * 6 + ("shared_attn",), repeats=6,
        suffix=("mamba", "mamba"),
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk=128),
        mlp_act="gelu", tie_embeddings=True,
    ).validate()


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b-smoke", family="hybrid",
        d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=256,
        pattern=("mamba", "mamba", "shared_attn"), repeats=2,
        suffix=("mamba",),
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                      n_groups=1, chunk=8),
        mlp_act="gelu", tie_embeddings=True,
    ).validate()
