"""hubert-xlarge [audio]: 48L d_model=1280 16H d_ff=5120 vocab=504
-- encoder-only (bidirectional), masked-frame cluster prediction.
The conv waveform frontend is a stub: the inputs are precomputed
512-d frame embeddings.  [arXiv:2106.07447; unverified]
Counterpart of ``repro/configs/hubert_xlarge.py``.
"""

from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge", family="audio",
        d_model=1280, num_heads=16, num_kv_heads=16, head_dim=80,
        d_ff=5120, vocab_size=504,            # k-means codebook targets
        pattern=("bidir",), repeats=48,
        causal=False, mlp_act="gelu",
        tie_embeddings=False,
        frontend="audio_frames", frontend_dim=512,
    ).validate()


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="hubert-xlarge-smoke", family="audio",
        d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=32,
        pattern=("bidir",), repeats=2,
        causal=False, mlp_act="gelu",
        tie_embeddings=False,
        frontend="audio_frames", frontend_dim=24,
    ).validate()
