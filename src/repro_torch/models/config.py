"""Unified model configuration: the counterpart of ``repro/models/config.py``.

The reference module is framework-free; the port keeps its own copy so
that it imports nothing of the JAX package.  One ``ModelConfig`` describes
every family of the reference's pool (dense GQA, MLA, MoE, Mamba2/SSD,
hybrid, encoder-only, early-fusion VLM) via a repeating *block pattern*
-- e.g. Gemma-2 is ``("local", "global") * 21``.  The port runs the dense
attention families so far (``repro_torch.models.transformer``).
"""

from __future__ import annotations

import dataclasses
from typing import Literal

BlockKind = Literal[
    "global",        # full causal attention + MLP
    "local",         # sliding-window causal attention + MLP
    "bidir",         # bidirectional attention + MLP (encoder-only)
    "mamba",         # Mamba2/SSD block
    "shared_attn",   # attention+MLP block with weights shared across uses
]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0       # DeepSeek shared experts (always on)
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 128
    dt_min: float = 0.001
    dt_max: float = 0.1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | ssm | moe | hybrid | audio | vlm
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # --- stack structure ---
    pattern: tuple[BlockKind, ...]
    repeats: int
    prefix: tuple[BlockKind, ...] = ()
    suffix: tuple[BlockKind, ...] = ()
    # --- attention flavour ---
    causal: bool = True
    sliding_window: int | None = None
    attn_logit_softcap: float | None = None
    final_logit_softcap: float | None = None
    query_scale: float | None = None  # overrides 1/sqrt(head_dim)
    rope_theta: float = 10000.0
    mla: MLAConfig | None = None
    # --- mlp flavour ---
    mlp_act: str = "silu"             # silu | gelu (GeGLU when gated)
    use_post_norms: bool = False      # Gemma-2/3 post-attn/post-mlp norms
    # --- optional subsystems ---
    moe: MoEConfig | None = None      # applied to attention blocks' MLP
    moe_in_prefix: bool = False       # prefix layers use dense MLP if False
    ssm: SSMConfig | None = None
    # --- embedding ---
    tie_embeddings: bool = True
    scale_embeddings: bool = False    # Gemma: x *= sqrt(d_model)
    frontend: str | None = None       # None | "audio_frames" (stub embeds)
    frontend_dim: int = 512
    norm_eps: float = 1e-6
    # --- remat / numerics knobs (hillclimb levers) ---
    remat: str = "full"               # full | dots | none
    logits_fp32: bool = True
    attn_fp32_softmax: bool = True    # False: bf16 logits (hillclimb lever)
    norm_fp32: bool = True            # False: bf16 norm-apply (hillclimb)
    manual_tp: bool = False           # shard_map Megatron-SP (RS+AG wire)

    @property
    def num_layers(self) -> int:
        return len(self.prefix) + len(self.pattern) * self.repeats + len(self.suffix)

    @property
    def padded_vocab_size(self) -> int:
        """Vocab padded to a multiple of 256 (Megatron-style) so the
        embedding shards evenly over any TP degree up to 256; padded
        logit columns are masked to -inf in the LM head."""
        return -(-self.vocab_size // 256) * 256

    @property
    def q_dim(self) -> int:
        if self.mla:
            return self.num_heads * (self.mla.qk_nope_head_dim
                                     + self.mla.qk_rope_head_dim)
        return self.num_heads * self.head_dim

    @property
    def has_attention(self) -> bool:
        kinds = set(self.prefix) | set(self.pattern) | set(self.suffix)
        return bool(kinds & {"global", "local", "bidir", "shared_attn"})

    @property
    def has_decode(self) -> bool:
        return self.causal   # encoder-only models have no autoregressive step

    @property
    def subquadratic(self) -> bool:
        """Eligible for the long_500k shape (DESIGN.md skip policy)."""
        if self.ssm is not None and self.mla is None:
            return True                       # SSM / hybrid
        if self.mla is not None:
            return True                       # compressed-KV (MLA)
        kinds = [k for k in (list(self.prefix)
                             + list(self.pattern) * self.repeats
                             + list(self.suffix))]
        local = sum(1 for k in kinds if k == "local")
        return self.sliding_window is not None and local >= len(kinds) // 2

    def layer_kinds(self) -> list[BlockKind]:
        return (list(self.prefix) + list(self.pattern) * self.repeats
                + list(self.suffix))

    def validate(self) -> "ModelConfig":
        assert self.num_heads % self.num_kv_heads == 0, "GQA group mismatch"
        if self.ssm is None:
            assert "mamba" not in self.layer_kinds()
        if self.moe is None:
            assert self.family not in ("moe",)
        return self


# ---------------------------------------------------------------------------
# Parameter counting (drives MODEL_FLOPS = 6*N*D in the roofline)
# ---------------------------------------------------------------------------

def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Analytical parameter count; `active_only` counts top-k experts only."""
    d = cfg.d_model
    n = 0
    n += cfg.padded_vocab_size * d                # embedding (as lowered)
    if not cfg.tie_embeddings:
        n += cfg.padded_vocab_size * d
    kinds = cfg.layer_kinds()
    shared_done = False
    for pos, kind in enumerate(kinds):
        if kind == "shared_attn":
            if shared_done:
                continue
            shared_done = True
        if kind == "mamba":
            s = cfg.ssm
            di = s.d_inner(d)
            nh = s.n_heads(d)
            conv_ch = di + 2 * s.n_groups * s.d_state
            n += d * (2 * di + 2 * s.n_groups * s.d_state + nh)  # in_proj
            n += conv_ch * s.d_conv + conv_ch                    # conv1d
            n += nh * 2                                          # A_log, D
            n += nh                                              # dt_bias
            n += di * d                                          # out_proj
            n += d                                               # norm
            continue
        # attention block
        if cfg.mla:
            m = cfg.mla
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            n += d * cfg.num_heads * qk                          # q
            n += d * (m.kv_lora_rank + m.qk_rope_head_dim)       # kv down
            n += m.kv_lora_rank * cfg.num_heads * (m.qk_nope_head_dim
                                                   + m.v_head_dim)
            n += cfg.num_heads * m.v_head_dim * d                # o
        else:
            n += d * cfg.num_heads * cfg.head_dim                # q
            n += 2 * d * cfg.num_kv_heads * cfg.head_dim         # k, v
            n += cfg.num_heads * cfg.head_dim * d                # o
        # mlp (dense or MoE); prefix layers are dense unless moe_in_prefix.
        in_prefix = pos < len(cfg.prefix)
        is_moe_layer = (cfg.moe is not None and kind != "shared_attn"
                        and (cfg.moe_in_prefix or not in_prefix))
        if is_moe_layer:
            e = cfg.moe
            per_expert = 3 * d * e.d_ff_expert
            experts = (e.top_k if active_only else e.num_experts)
            n += experts * per_expert
            n += e.num_shared_experts * per_expert
            n += d * e.num_experts                               # router
        else:
            n += 3 * d * cfg.d_ff                                # gate/up/down
        n += 2 * d                                               # norms
        if cfg.use_post_norms:
            n += 2 * d
    n += d                                                       # final norm
    return n
