"""gemma3-12b [dense]: 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144 -- 5:1 local:global, 128k context.
[hf:google/gemma-3-1b-pt; unverified]
Counterpart of ``repro/configs/gemma3_12b.py``.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b", family="dense",
        d_model=3840, num_heads=16, num_kv_heads=8, head_dim=256,
        d_ff=15360, vocab_size=262144,
        pattern=("local",) * 5 + ("global",), repeats=8,   # 48 layers
        sliding_window=1024,
        attn_logit_softcap=None, final_logit_softcap=None,  # dropped in v3
        query_scale=256.0 ** -0.5,
        mlp_act="gelu", use_post_norms=True,
        tie_embeddings=True, scale_embeddings=True,
        rope_theta=1_000_000.0,
    ).validate()


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b-smoke", family="dense",
        d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512,
        pattern=("local",) * 5 + ("global",), repeats=1,
        sliding_window=8,
        query_scale=16.0 ** -0.5,
        mlp_act="gelu", use_post_norms=True,
        tie_embeddings=True, scale_embeddings=True,
        rope_theta=1_000_000.0,
    ).validate()
