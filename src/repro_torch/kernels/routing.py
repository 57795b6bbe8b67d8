"""Split-path routing (K14b) over a materialized u_hat.

The counterpart of ``repro/kernels/routing.py`` (``_routing_kernel``):
u_hat [B, I, J*D] -> v [B, J*D], every routing iteration in one kernel,
inference only (no stop-gradient).  ``routing`` runs ``routing_plain`` for
CPU tensors and the CUDA kernel (``csrc/routing.cu``, one CTA per sample)
for CUDA tensors.  The twin follows the kernel's schedule: ``iters + 1``
passes over i-blocks of ``block_i`` rows, pass ``t`` folding the logits
update of iteration ``t`` into the accumulation of ``s_t`` -- the fused
s+b schedule of ``votes_routing``'s streamed mode, with the votes read
instead of recomputed.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.execplan import routing_split_smem
from repro_torch.core.planner import SMEM_BYTES
from repro_torch.kernels import ref
from repro_torch.kernels.build import Kernel, on_cpu, ptr, stream_of

_P, _I = ctypes.c_void_p, ctypes.c_int
ROUTING = Kernel("routing", "routing_f32", [_P, _P] + [_I] * 7 + [_P])


def routing_plain(u_hat: torch.Tensor, *, iters: int, num_classes: int,
                  block_i: int) -> torch.Tensor:
    """The kernel's schedule in plain PyTorch: u_hat [B, I, J*D] ->
    v [B, J*D]."""
    bsz, i_dim, jd = u_hat.shape
    j, d = num_classes, jd // num_classes
    uh4 = u_hat.reshape(bsz, i_dim, j, d)
    b = torch.zeros((bsz, i_dim, j), dtype=u_hat.dtype, device=u_hat.device)
    v = None
    for t in range(iters + 1):
        s = torch.zeros((bsz, j, d), dtype=u_hat.dtype, device=u_hat.device)
        for i0 in range(0, i_dim, block_i):
            rows = slice(i0, i0 + block_i)
            if t > 0:      # iteration t's logits update rides this pass
                b[:, rows] += torch.einsum("bijd,bjd->bij", uh4[:, rows], v)
            c = torch.softmax(b[:, rows], dim=2)
            s = s + torch.einsum("bij,bijd->bjd", c, uh4[:, rows])
        v = ref.squash(s)
    return v.reshape(bsz, jd)


def routing(u_hat: torch.Tensor, *, iters: int = 3, num_classes: int = 10,
            block_i: int = 128) -> torch.Tensor:
    """K14b: u_hat [B, I, J*D] -> v [B, J*D] after ``iters`` routing
    iterations.  ``block_i`` (the u_hat rows one pass holds in shared
    memory at a time) is clamped to I."""
    if u_hat.dim() != 3:
        raise ValueError(f"routing: u_hat must be [B, I, J*D], got "
                         f"{tuple(u_hat.shape)}")
    bsz, i_dim, jd = u_hat.shape
    if num_classes < 1 or jd % num_classes:
        raise ValueError(f"votes dim {jd} not divisible by classes "
                         f"{num_classes}")
    if iters < 0:
        raise ValueError(f"routing needs iters >= 0, got {iters}")
    block_i = max(1, min(block_i, i_dim))
    if on_cpu("routing", u_hat):
        return routing_plain(u_hat, iters=iters, num_classes=num_classes,
                             block_i=block_i)
    j = num_classes
    smem = routing_split_smem(i_dim, j, jd, block_i)
    if smem > SMEM_BYTES:
        raise ValueError(f"routing: block_i={block_i} needs {smem} B of "
                         f"shared memory per CTA, over {SMEM_BYTES} B")
    out = torch.empty((bsz, jd), dtype=u_hat.dtype, device=u_hat.device)
    if bsz:
        ROUTING(ptr(u_hat), ptr(out), bsz, i_dim, j, jd // j, iters, block_i,
                smem, stream_of(u_hat))
    return out
