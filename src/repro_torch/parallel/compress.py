"""Gradient compression: int8 quantization with error feedback -- the
counterpart of ``repro/parallel/compress.py``.

Each data-parallel worker quantizes its local gradient to int8 with a
per-tensor scale, all-reduces the int8 payload, dequantizes, and keeps
the quantization residual locally: error feedback makes the scheme
unbiased over time (Seide et al.; the 1-bit Adam lineage).

Two entry points:
  * ``ef_quantize`` / ``ef_dequantize`` (and ``compress_grads_tree`` over
    a tree) -- the numerics, testable anywhere;
  * ``compressed_psum`` -- the all-reduce over a process group; the
    pre-scaling by 1/world guards the int8 range during the sum.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from repro_torch import tree as trees

INT8_MAX = 127.0


def _scale_of(g32: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / INT8_MAX


def ef_quantize(g: torch.Tensor, residual: torch.Tensor | None
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(q int8, scale, new residual)``; ``residual`` has g's shape."""
    g32 = g.float()
    if residual is not None:
        g32 = g32 + residual
    scale = _scale_of(g32)
    q = torch.clamp(torch.round(g32 / scale), -INT8_MAX, INT8_MAX)
    new_residual = g32 - q * scale
    return q.to(torch.int8), scale, new_residual


def ef_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_grads_tree(grads: Any, residuals: Any | None
                        ) -> tuple[Any, Any]:
    """Quantize-dequantize every leaf with error feedback (the numerics of
    the compressed all-reduce without a process group).  Returns the
    dequantized tree (each leaf in its own type) and the residuals."""
    flat = trees.leaves(grads)
    res = (trees.leaves(residuals) if residuals is not None
           else [None] * len(flat))
    out, new_res = [], []
    for g, r in zip(flat, res, strict=True):
        q, s, nr = ef_quantize(g, r)
        out.append(ef_dequantize(q, s).to(g.dtype))
        new_res.append(nr)
    it_out, it_res = iter(out), iter(new_res)
    return (trees.tree_map(lambda _: next(it_out), grads),
            trees.tree_map(lambda _: next(it_res), grads))


def compressed_psum(g: torch.Tensor, group, world: int,
                    residual: torch.Tensor | None = None
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The int8 all-reduce over ``group`` with a per-tensor scale: the
    mean of the ranks' ``g`` (within the quantization error) and this
    rank's new residual.

    The local gradient is pre-divided by ``world`` so the int8 sum cannot
    overflow; the scales are max-reduced so every rank dequantizes
    identically; the rounded payload is summed as int32 (the reference's
    ``psum`` of ``q.astype(int32)``)."""
    g32 = g.float() / world
    if residual is not None:
        g32 = g32 + residual
    scale = _scale_of(g32)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q = torch.clamp(torch.round(g32 / scale), -INT8_MAX, INT8_MAX
                    ).to(torch.int8)
    new_residual = g32 - q.float() * scale
    summed = q.to(torch.int32)
    dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
    return summed.float() * scale, new_residual
