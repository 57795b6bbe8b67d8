"""Fused RMSNorm (K16): ``y = x * rsqrt(mean(x^2) + eps) * (1 + w)``.

The counterpart of ``repro/kernels/rmsnorm.py``'s ``_rmsnorm_kernel``:
fp32 statistics, the output in x's type (fp32 or bf16).  ``rmsnorm``
runs ``rmsnorm_plain`` for CPU tensors and the CUDA kernel
(``csrc/rmsnorm.cu``) for CUDA tensors.  Forward only: the reference has
no backward kernel either, and on the card the wrapper refuses inputs
that require grad rather than cut the autograd graph.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.build import (Kernel, on_cpu, ptr, refuse_grad,
                                       stream_of)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
RMSNORM = Kernel("rmsnorm", "rmsnorm", [_I, _P, _P, _P, _L, _I, _F, _I, _P])

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 8192                    # csrc/rmsnorm.cu kMaxD


def rmsnorm_plain(x: torch.Tensor, weight: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """x [..., D], weight [D] -> x's shape and type."""
    return ref.rmsnorm(x, weight, eps)


def _aligned16(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """K16: x [..., D] (fp32 or bf16), weight [D] -> x's shape and type."""
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
    if x2.shape[0]:
        RMSNORM(DTYPES[x.dtype], ptr(x2), ptr(w32), ptr(out), x2.shape[0], d,
                eps, int(vec16), stream_of(x))
    return out.reshape(x.shape)
