"""Split-path capsule votes (K14a): u_hat written to device memory.

The counterpart of ``repro/kernels/caps_votes.py`` (``_votes_kernel``):
u [B, I, C], W [I, N, C] -> u_hat [B, I, N], ``u_hat[b, i, n] =
sum_c W[i, n, c] u[b, i, c]``.  ``caps_votes`` runs ``caps_votes_plain``
for CPU tensors and the CUDA kernel (``csrc/caps_votes.cu``, one CTA per
i-block, a thread per (i, n) column, W streamed through registers, u
staged in shared memory a chunk of samples at a time) for CUDA
tensors.  The twin repeats the kernel's arithmetic: each element a
chain of fp32 ``fmaf`` over c = 0..C-1 from 0, so the two agree bit for
bit on every shape (a cuBLAS product, as ``torch.einsum`` runs it, sums in
an order of its own choosing).  Forward only, as in the reference: the
plan-driven path runs the fused ``votes_routing`` instead, and this
kernel is the paper's baseline that the fusion is measured against.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.execplan import caps_votes_grid, caps_votes_smem
from repro_torch.core.planner import SMEM_BYTES
from repro_torch.kernels.build import Kernel, on_cpu, ptr, stream_of

_P, _I = ctypes.c_void_p, ctypes.c_int
CAPS_VOTES = Kernel("caps_votes", "caps_votes_f32",
                    [_P] * 3 + [_I] * 7 + [_P])


def fmaf(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fp32 ``fmaf(a, b, c)``, rounded once, on any device: a * b is exact
    in fp64, c + a * b is rounded to odd in fp64 (its TwoSum residual
    says which neighbour), and a number rounded to odd with 53 bits
    rounds to 24 as the exact value would."""
    p = a.double() * b.double()
    c = c.double()
    s = c + p
    t = s - c
    err = (c - (s - t)) + (p - t)               # s + err == c + p exactly
    even = (s.view(torch.int64) & 1) == 0
    away = torch.nextafter(s, torch.where(err > 0, torch.inf, -torch.inf))
    return torch.where((err != 0) & even, away, s).float()


def caps_votes_plain(u: torch.Tensor, w: torch.Tensor, *,
                     block_i: int) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: u [B, I, C], w [I, N, C]
    -> [B, I, N], each element ``fmaf`` over c = 0..C-1 from 0.  No
    element depends on ``block_i`` (the kernel's rows a CTA)."""
    del block_i
    out = torch.zeros(u.shape[0], u.shape[1], w.shape[1], dtype=u.dtype,
                      device=u.device)
    for c in range(u.shape[2]):
        out = fmaf(w[None, :, :, c], u[:, :, None, c], out)
    return out


def caps_votes(u: torch.Tensor, w: torch.Tensor, *,
               block_i: int = 128) -> torch.Tensor:
    """K14a: u [B, I, C], w [I, N, C] -> u_hat [B, I, N].  ``block_i`` is
    clamped to I; I need not divide it (the last block is ragged)."""
    if u.dim() != 3 or w.dim() != 3 or w.shape[0] != u.shape[1] \
            or w.shape[2] != u.shape[2]:
        raise ValueError(f"caps_votes: u {tuple(u.shape)} and w "
                         f"{tuple(w.shape)} must be [B, I, C] and [I, N, C]")
    bsz, i_dim, c = u.shape
    n = w.shape[1]
    block_i = max(1, min(block_i, i_dim))
    if on_cpu("caps_votes", u, w):
        return caps_votes_plain(u, w, block_i=block_i)
    smem = caps_votes_smem(bsz, block_i, c)
    if smem > SMEM_BYTES:
        raise ValueError(f"caps_votes: block_i={block_i} at batch {bsz} "
                         f"needs {smem} B of shared memory per CTA, over "
                         f"{SMEM_BYTES} B")
    out = torch.empty((bsz, i_dim, n), dtype=u.dtype, device=u.device)
    if out.numel():
        _, threads = caps_votes_grid(i_dim, n, block_i)
        CAPS_VOTES(ptr(u), ptr(w), ptr(out), bsz, i_dim, c, n, block_i,
                   threads, smem, stream_of(u))
    return out
