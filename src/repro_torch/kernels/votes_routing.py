"""Fused ClassCaps votes + routing (K3 resident / K4 streamed).

The counterpart of ``repro/kernels/votes_routing.py``'s forward
(``_resident_kernel`` / ``_streamed_kernel`` through ``_vr_apply``).
``votes_routing`` runs ``votes_routing_plain`` for CPU tensors and the
CUDA kernel (``csrc/votes_routing.cu``, one CTA per sample) for CUDA
tensors.  The plain twin follows the reference's schedule math: the i
axis is zero-padded to a multiple of ``block_i``; ``resident`` computes
the votes once and iterates on them; ``streamed`` recomputes each votes
block on every pass and folds the logits update of iteration ``t`` into
the same pass as the accumulation of ``s_t``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.execplan import MODES, votes_routing_smem
from repro_torch.core.planner import SMEM_BYTES
from repro_torch.kernels import ref
from repro_torch.kernels.build import Kernel, on_cpu, ptr, stream_of

_P, _I = ctypes.c_void_p, ctypes.c_int
VOTES_ROUTING = Kernel("votes_routing", "votes_routing_f32",
                       [_P] * 3 + [_I] * 9 + [_P])


def _votes_block(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """u: [B, TI, C], w: [TI, N, C] -> u_hat block [B, TI, N]."""
    return torch.einsum("bic,inc->bin", u, w)


def _padded(u: torch.Tensor, w: torch.Tensor, block_i: int):
    """Zero-pad the capsule axis to a multiple of ``block_i``: zero rows
    add nothing to s and leave the real capsules untouched."""
    i_dim = u.shape[1]
    n_blocks = -(-i_dim // block_i)
    pad = n_blocks * block_i - i_dim
    if pad:
        u = torch.nn.functional.pad(u, (0, 0, 0, pad))
        w = torch.nn.functional.pad(w, (0, 0, 0, 0, 0, pad))
    return u, w, n_blocks


def check_schedule(i_dim: int, jd: int, *, iters: int, num_classes: int,
                   mode: str, block_i: int) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; choose from {MODES}")
    if num_classes < 1 or jd % num_classes:
        raise ValueError(f"votes dim {jd} not divisible by classes "
                         f"{num_classes}")
    if iters < 1:
        raise ValueError(f"routing needs iters >= 1, got {iters}")
    if not 1 <= block_i <= i_dim:
        raise ValueError(f"block_i={block_i} outside [1, {i_dim}]")


def votes_routing_plain(u: torch.Tensor, w: torch.Tensor, *, iters: int,
                        num_classes: int, mode: str,
                        block_i: int) -> torch.Tensor:
    """The schedule both kernels run, in plain PyTorch: u [B, I, C],
    w [I, J*D, C] -> v [B, J*D]."""
    check_schedule(u.shape[1], w.shape[1], iters=iters,
                   num_classes=num_classes, mode=mode, block_i=block_i)
    bsz, _, _ = u.shape
    jd = w.shape[1]
    j, d = num_classes, jd // num_classes
    u, w, n_blocks = _padded(u, w, block_i)
    blocks = [slice(ib * block_i, (ib + 1) * block_i)
              for ib in range(n_blocks)]
    if mode == "resident":
        votes = torch.cat([_votes_block(u[:, r], w[r]) for r in blocks], 1)
        return ref.routing(votes.reshape(bsz, -1, j, d),
                           iters).reshape(bsz, jd)
    b = torch.zeros((bsz, u.shape[1], j), dtype=u.dtype, device=u.device)
    v = None
    for t in range(iters + 1):
        s = torch.zeros((bsz, j, d), dtype=u.dtype, device=u.device)
        for rows in blocks:
            uh4 = _votes_block(u[:, rows], w[rows]).reshape(bsz, -1, j, d)
            if t > 0:      # iteration t's logits update rides this W stream
                b[:, rows] += torch.einsum("bijd,bjd->bij", uh4, v)
            c = torch.softmax(b[:, rows], dim=2)
            s = s + torch.einsum("bij,bijd->bjd", c, uh4)
        v = ref.squash(s)
    return v.reshape(bsz, jd)


def votes_routing(u: torch.Tensor, w: torch.Tensor, *, iters: int = 3,
                  num_classes: int = 10, mode: str = "streamed",
                  block_i: int = 128) -> torch.Tensor:
    """K3/K4: u [B, I, C], w [I, J*D, C] -> v [B, J*D] (votes + routing,
    u_hat never leaves the chip on CUDA)."""
    if u.dim() != 3 or w.dim() != 3 or w.shape[0] != u.shape[1] \
            or w.shape[2] != u.shape[2]:
        raise ValueError(f"votes_routing: u {tuple(u.shape)} and w "
                         f"{tuple(w.shape)} must be [B, I, C] and "
                         f"[I, J*D, C]")
    bsz, i_dim, c = u.shape
    jd = w.shape[1]
    block_i = min(block_i, i_dim)
    check_schedule(i_dim, jd, iters=iters, num_classes=num_classes,
                   mode=mode, block_i=block_i)
    if on_cpu("votes_routing", u, w):
        return votes_routing_plain(u, w, iters=iters,
                                   num_classes=num_classes, mode=mode,
                                   block_i=block_i)
    j = num_classes
    smem = votes_routing_smem(mode, i_dim, block_i, c, j, jd)
    if smem > SMEM_BYTES:
        raise ValueError(f"votes_routing: the {mode} schedule needs {smem} B "
                         f"of shared memory per CTA, over {SMEM_BYTES} B")
    out = torch.empty((bsz, jd), dtype=u.dtype, device=u.device)
    VOTES_ROUTING(ptr(u), ptr(w), ptr(out), bsz, i_dim, c, j, jd // j, iters,
                  int(mode == "resident"), block_i, smem, stream_of(u))
    return out
