"""Standalone capsule squash (K10) and its VJP.

The counterpart of ``repro/kernels/squash.py``: ``_squash_kernel`` and
``_squash_bwd_kernel`` behind the ``_squash_core`` custom VJP.  ``squash``
is a ``torch.autograd.Function`` that saves its input: forward
``squash_plain`` for CPU tensors and the CUDA kernel (``csrc/squash.cu``)
for CUDA tensors; backward ``squash_bwd``, whose plain twin is
``ref.squash_vjp`` and whose kernel evaluates the same formula.  Rows are
independent, so ``block_rows`` (the rows one CTA takes) changes only how
the card spreads them, never the result; ``lanes`` (the threads that
share a row, ``execplan.squash_lanes`` unless given) changes the order of
the row's sum of squares, within rounding.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.execplan import (squash_block_rows, squash_grid,
                                      squash_lanes)
from repro_torch.kernels import ref
from repro_torch.kernels.build import Kernel, on_cpu, ptr, stream_of

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SQUASH = Kernel("squash", "squash_f32", [_P, _P, _L] + [_I] * 4 + [_P])
SQUASH_BWD = Kernel("squash", "squash_bwd_f32",
                    [_P] * 3 + [_L] + [_I] * 4 + [_P])


def squash_plain(x: torch.Tensor) -> torch.Tensor:
    """x [R, D] -> squash over the last axis."""
    return ref.squash(x)


def squash_bwd_plain(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The VJP of ``squash_plain`` at ``x`` for the cotangent ``g``."""
    return ref.squash_vjp(x, g)


def _lanes(name: str, x: torch.Tensor, block_rows: int,
           lanes: int | None) -> int:
    """Check x [R, D] and the knobs; the lanes a row (the plan's for D
    unless given)."""
    if x.dim() != 2 or x.shape[1] < 1:
        raise ValueError(f"{name}: x must be [R, D] with D >= 1, got "
                         f"{tuple(x.shape)}")
    if block_rows < 1:
        raise ValueError(f"{name}: block_rows={block_rows} < 1")
    lanes = squash_lanes(x.shape[1]) if lanes is None else lanes
    if lanes not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"{name}: lanes={lanes} is not a power of two "
                         f"up to 32")
    return lanes


def squash_rows(x: torch.Tensor, *, block_rows: int,
                lanes: int | None = None) -> torch.Tensor:
    """K10 forward, not differentiable: x [R, D] -> [R, D]."""
    lanes = _lanes("squash", x, block_rows, lanes)
    if on_cpu("squash", x):
        return squash_plain(x)
    out = torch.empty_like(x)
    rows, d = x.shape
    if rows:
        SQUASH(ptr(x), ptr(out), rows, d, block_rows, lanes,
               squash_grid(rows, block_rows, lanes)[1], stream_of(x))
    return out


def squash_bwd(x: torch.Tensor, g: torch.Tensor, *, block_rows: int,
               lanes: int | None = None) -> torch.Tensor:
    """K10 backward: dx [R, D] of ``squash`` at x [R, D] for g [R, D]."""
    lanes = _lanes("squash_bwd", x, block_rows, lanes)
    if g.shape != x.shape:
        raise ValueError(f"squash_bwd: cotangent {tuple(g.shape)}, "
                         f"expected {tuple(x.shape)}")
    if on_cpu("squash_bwd", x, g):
        return squash_bwd_plain(x, g)
    dx = torch.empty_like(x)
    rows, d = x.shape
    if rows:
        SQUASH_BWD(ptr(x), ptr(g), ptr(dx), rows, d, block_rows, lanes,
                   squash_grid(rows, block_rows, lanes)[1], stream_of(x))
    return dx


class SquashFunction(torch.autograd.Function):
    """The reference's ``_squash_core`` custom VJP: saves x; the backward
    runs ``squash_bwd`` on the same rows per CTA."""

    @staticmethod
    def forward(ctx, x, block_rows: int):
        ctx.block_rows = block_rows
        ctx.save_for_backward(x)
        return squash_rows(x, block_rows=block_rows)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return squash_bwd(x, g.contiguous(), block_rows=ctx.block_rows), None


def squash(x: torch.Tensor, *, block_rows: int | None = None) -> torch.Tensor:
    """x [..., D] -> squash over the last axis (K10), differentiable.
    ``block_rows`` defaults to the Hopper pick for D and the row count
    (``execplan.squash_block_rows``)."""
    rows = x.reshape(-1, x.shape[-1]).contiguous()
    if block_rows is None:
        block_rows = squash_block_rows(rows.shape[1], rows.shape[0])
    out = SquashFunction.apply(rows, block_rows)
    return out.reshape(x.shape)
