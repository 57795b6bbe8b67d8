"""Assigned input shapes x skip policy x shape builders: the counterpart
of ``repro/launch/shapes.py``.

``train_*`` cells run ``train_step``; ``prefill_*`` run ``prefill_step``;
``decode_*`` / ``long_*`` run ``serve_step`` (one new token against a KV
cache of seq_len).  The builders make every tensor on ``device="meta"``,
the counterpart of ``jax.eval_shape``: shapes and dtypes, never memory.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import init_model, init_model_cache
from repro_torch.train.optimizer import init_opt_state

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str           # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def cell_supported(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """The reference's skip policy."""
    if shape.kind == "decode" and not cfg.has_decode:
        return False, "encoder-only: no autoregressive decode step"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention stack: long_500k requires "
                       "sub-quadratic attention")
    return True, ""


# ---------------------------------------------------------------------------
# Meta-tensor builders (never allocate)
# ---------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def param_specs(cfg: ModelConfig, dtype: torch.dtype) -> dict:
    gen = torch.Generator(device="cpu").manual_seed(0)
    return init_model(gen, cfg, dtype, device=META)


def opt_specs(params) -> dict:
    return init_opt_state(params)


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    b, t = shape.global_batch, shape.seq_len
    if cfg.frontend == "audio_frames":
        return {"inputs": _meta((b, t, cfg.frontend_dim), torch.bfloat16),
                "targets": _meta((b, t), torch.int32)}
    return {"inputs": _meta((b, t), torch.int32),
            "targets": _meta((b, t), torch.int32)}


def cache_specs(cfg: ModelConfig, shape: ShapeSpec,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    return init_model_cache(cfg, shape.global_batch, shape.seq_len, dtype,
                            device=META)


def decode_specs(cfg: ModelConfig, shape: ShapeSpec) -> tuple:
    """(cache, token, index) for serve_step."""
    token = _meta((shape.global_batch, 1), torch.int32)
    index = _meta((), torch.int32)
    return cache_specs(cfg, shape), token, index


def prefill_specs(cfg: ModelConfig, shape: ShapeSpec) -> torch.Tensor:
    b, t = shape.global_batch, shape.seq_len
    if cfg.frontend == "audio_frames":
        return _meta((b, t, cfg.frontend_dim), torch.bfloat16)
    return _meta((b, t), torch.int32)


def input_specs(cfg: ModelConfig, shape_name: str, *,
                train_dtype: torch.dtype = torch.float32,
                serve_dtype: torch.dtype = torch.bfloat16) -> dict:
    """Every meta-tensor stand-in for one (arch x shape) cell."""
    shape = SHAPES[shape_name]
    ok, why = cell_supported(cfg, shape)
    if not ok:
        raise ValueError(f"{cfg.name} x {shape_name} skipped: {why}")
    if shape.kind == "train":
        params = param_specs(cfg, train_dtype)
        return {"kind": "train", "params": params,
                "opt_state": opt_specs(params),
                "batch": batch_specs(cfg, shape)}
    params = param_specs(cfg, serve_dtype)
    if shape.kind == "prefill":
        return {"kind": "prefill", "params": params,
                "tokens": prefill_specs(cfg, shape)}
    cache, token, index = decode_specs(cfg, shape)
    return {"kind": "decode", "params": params, "cache": cache,
            "token": token, "index": index}
