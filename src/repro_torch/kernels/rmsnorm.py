"""Fused RMSNorm (K16): ``y = x * rsqrt(mean(x^2) + eps) * (1 + w)``.

The counterpart of ``repro/kernels/rmsnorm.py``'s ``_rmsnorm_kernel``:
fp32 statistics, the output in x's type (fp32 or bf16).  ``rmsnorm``
runs ``rmsnorm_plain`` for CPU tensors and the CUDA kernel
(``csrc/rmsnorm.cu``) for CUDA tensors.  Forward only: the reference has
no backward kernel either, and on the card the wrapper refuses inputs
that require grad rather than cut the autograd graph.

The kernel has two forms, which ``plan`` picks from D alone: a warp a
row for D <= 1024, and a CTA a row above (gemma2-9b's D = 3584, decode
and prefill alike), which issues every load of x and w before its one
reduction.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.build import (Kernel, on_cpu, ptr, refuse_grad,
                                       stream_of)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
RMSNORM = Kernel("rmsnorm", "rmsnorm",
                 [_I, _P, _P, _P, _L, _I, _F, _I, _I, _P])

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 8192                    # csrc/rmsnorm.cu kMaxD
WARP_MAX_D = 1024               # csrc/rmsnorm.cu kWarpMaxD
WARP_ROWS = 0                   # ``threads`` of the warp-a-row form
VECTORS_A_THREAD = 2            # a thread's 16-byte vectors in a CTA a row
ELEMENTS_A_THREAD = 8           # its elements on the element-wise path
# The CTA sizes of the CTA-a-row form (csrc/rmsnorm.cu compiles these).
# chip_smoke's form sweep (H100): at D = 3584, 512 threads a row beat 1024
# at 1-4608 rows in fp32 and bf16 but one site (264 rows fp32, 1%); at
# D = 1024 the warp a row beat the CTA a row at 4608 rows and lost at 4
# and 132 (no model path on the card normalises rows that narrow).
CTA_THREADS = (512, 1024)


def rmsnorm_plain(x: torch.Tensor, weight: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """x [..., D], weight [D] -> x's shape and type.  It sums the squares
    in ``torch.mean``'s order; the kernel sums each thread's elements in
    order, then lanes by an xor tree, then warps (csrc/rmsnorm.cu), and
    is held to this within 2e-5 (fp32) / 2e-2 (bf16)."""
    return ref.rmsnorm(x, weight, eps)


def plan(d: int, vec: int) -> int:
    """The form a row of ``d`` elements takes, loaded ``vec`` at a time:
    ``WARP_ROWS`` (0) for ``d`` <= ``WARP_MAX_D``, else the threads of a
    CTA a row -- the fewest of ``CTA_THREADS`` that hold the row in
    ``VECTORS_A_THREAD`` vectors a thread (``ELEMENTS_A_THREAD`` elements
    on the element-wise path)."""
    if d <= WARP_MAX_D:
        return WARP_ROWS
    for t in CTA_THREADS:
        if _holds(t, d, vec):
            return t
    return CTA_THREADS[-1]


def _holds(threads: int, d: int, vec: int) -> bool:
    """Whether the form ``threads`` holds a row of ``d`` elements."""
    if threads == WARP_ROWS:
        return d <= WARP_MAX_D
    per = VECTORS_A_THREAD if vec > 1 else ELEMENTS_A_THREAD
    return -(-(d // vec) // threads) <= per


def _aligned16(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """K16: x [..., D] (fp32 or bf16), weight [D] -> x's shape and type.
    On the card it launches ``plan``'s form."""
    return _rmsnorm(x, weight, eps, None)


def rmsnorm_form(x: torch.Tensor, weight: torch.Tensor, threads: int, *,
                 eps: float = 1e-6) -> torch.Tensor:
    """A measurement aid, on no model path: K16 in the form ``threads``
    names (``WARP_ROWS`` or one of ``CTA_THREADS``) instead of
    ``plan``'s, for the form sweep on the card and the card's tests."""
    if threads not in (WARP_ROWS, *CTA_THREADS):
        raise ValueError(f"rmsnorm: no form of {threads} threads")
    return _rmsnorm(x, weight, eps, threads)


def _rmsnorm(x, weight, eps, threads):
    d = x.shape[-1]
    if weight.shape != (d,):
        raise ValueError(f"rmsnorm: weight {tuple(weight.shape)}, expected "
                         f"({d},)")
    if on_cpu("rmsnorm", x, weight, dtypes=tuple(DTYPES)):
        return rmsnorm_plain(x, weight, eps)
    refuse_grad("rmsnorm", x, weight)
    if not 1 <= d <= MAX_D:
        raise ValueError(f"rmsnorm: D={d} outside the kernel's 1..{MAX_D}")
    x2 = x.reshape(-1, d)
    w32 = weight.float().contiguous()
    out = torch.empty_like(x2)
    vec = 16 // x.element_size()
    vec16 = (d % vec == 0 and all(map(_aligned16, (x2, w32, out))))
    vec = vec if vec16 else 1
    if threads is None:
        threads = plan(d, vec)
    elif not _holds(threads, d, vec):
        raise ValueError(f"rmsnorm: a form of {threads} threads cannot hold "
                         f"D={d} loaded {vec} at a time")
    if x2.shape[0]:
        RMSNORM(DTYPES[x.dtype], ptr(x2), ptr(w32), ptr(out), x2.shape[0], d,
                eps, int(vec16), threads, stream_of(x))
    return out.reshape(x.shape)


def empty_launch(rows: int, threads: int, device: torch.device) -> None:
    """On the card: an empty kernel of ``rows`` CTAs of ``threads``
    threads (the CTA-a-row form's launch) on the current stream -- the
    floor under it (a measurement aid, on no model path, counted
    nowhere)."""
    build.call("rmsnorm", "rmsnorm_empty_launch", [_L, _I, _P], rows,
               threads,
               ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
