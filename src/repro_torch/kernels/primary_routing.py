"""Pipelined PrimaryCaps -> routing kernel (K5): u never leaves the chip.

The counterpart of ``repro/kernels/primary_routing.py``'s forward
(``_produce_u`` + ``_pipe_resident_kernel`` / ``_pipe_streamed_kernel``
through ``_pr_apply``).  ``primary_routing`` extracts the PrimaryCaps
patches with K1, as ``_pr_apply`` does, then runs
``primary_routing_patches``: the plain twin for CPU tensors, the CUDA
kernel (``csrc/primary_routing.cu``, one CTA per sample) for CUDA
tensors.  Capsule row ``i = p * groups + g`` of u is channels
``[g*C, (g+1)*C)`` of patch position ``p``, so the producer's output
rows are the capsule rows with no reshuffle.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.execplan import (PIPE_MAX_CHANNELS, PIPE_MAX_POSITIONS,
                                       primary_routing_smem)
from repro_torch.core.planner import SMEM_BYTES
from repro_torch.kernels import ref
from repro_torch.kernels.build import Kernel, on_cpu, ptr, stream_of
from repro_torch.kernels.conv_im2col import im2col_patches
from repro_torch.kernels.votes_routing import (check_schedule,
                                               votes_routing_plain)

_P, _I = ctypes.c_void_p, ctypes.c_int
PRIMARY_ROUTING = Kernel("primary_routing", "primary_routing_f32",
                         [_P] * 5 + [_I] * 12 + [_P])


def primary_routing_patches_plain(patches: torch.Tensor, w_pc: torch.Tensor,
                                  b_pc: torch.Tensor, w_cc: torch.Tensor, *,
                                  iters: int, num_classes: int, mode: str,
                                  block_i: int) -> torch.Tensor:
    """patches [B, P, K], w_pc [K, N], b_pc [N], w_cc [I, J*D, C] ->
    v [B, J*D]: the produce phase (GEMM + bias + per-capsule squash),
    then the votes + routing schedule on u."""
    bsz = patches.shape[0]
    i_dim, _, caps_dim = w_cc.shape
    u = ref.squash((patches @ w_pc + b_pc).reshape(bsz, i_dim, caps_dim))
    return votes_routing_plain(u, w_cc, iters=iters, num_classes=num_classes,
                               mode=mode, block_i=block_i)


def primary_routing_patches(patches: torch.Tensor, w_pc: torch.Tensor,
                            b_pc: torch.Tensor, w_cc: torch.Tensor, *,
                            iters: int = 3, num_classes: int = 10,
                            mode: str = "streamed", block_i: int = 128,
                            block_k: int = 32) -> torch.Tensor:
    """K5 from the PrimaryCaps patches (see ``primary_routing``)."""
    bsz, p_pos, kk = patches.shape
    n_ch = w_pc.shape[1]
    i_dim, jd, caps_dim = w_cc.shape
    if w_pc.shape[0] != kk or b_pc.shape != (n_ch,) or n_ch % caps_dim \
            or p_pos * (n_ch // caps_dim) != i_dim:
        raise ValueError(
            f"primary_routing: patches {tuple(patches.shape)}, W_pc "
            f"{tuple(w_pc.shape)}, W_cc {tuple(w_cc.shape)}: the producer "
            f"must emit the {i_dim} capsules W_cc expects")
    block_i = min(block_i, i_dim)
    check_schedule(i_dim, jd, iters=iters, num_classes=num_classes,
                   mode=mode, block_i=block_i)
    if on_cpu("primary_routing", patches, w_pc, b_pc, w_cc):
        return primary_routing_patches_plain(
            patches, w_pc, b_pc, w_cc, iters=iters, num_classes=num_classes,
            mode=mode, block_i=block_i)
    if p_pos > PIPE_MAX_POSITIONS or n_ch > PIPE_MAX_CHANNELS \
            or not 1 <= block_k <= kk:
        raise ValueError(
            f"primary_routing: {p_pos} positions x {n_ch} channels with "
            f"block_k={block_k} is outside the kernel's limits "
            f"({PIPE_MAX_POSITIONS} x {PIPE_MAX_CHANNELS}, 1 <= block_k "
            f"<= {kk})")
    j = num_classes
    smem = primary_routing_smem(mode, p_pos, n_ch, block_k, i_dim, block_i,
                                caps_dim, j, jd)
    if smem > SMEM_BYTES:
        raise ValueError(f"primary_routing: the {mode} schedule needs {smem} "
                         f"B of shared memory per CTA, over {SMEM_BYTES} B")
    out = torch.empty((bsz, jd), dtype=patches.dtype, device=patches.device)
    PRIMARY_ROUTING(ptr(patches), ptr(w_pc), ptr(b_pc), ptr(w_cc), ptr(out),
                    bsz, p_pos, kk, n_ch, caps_dim, j, jd // j, iters,
                    int(mode == "resident"), block_i, block_k, smem,
                    stream_of(patches))
    return out


def primary_routing(x: torch.Tensor, w_pc: torch.Tensor, b_pc: torch.Tensor,
                    w_cc: torch.Tensor, *, stride: int = 2, iters: int = 3,
                    num_classes: int = 10, mode: str = "streamed",
                    block_i: int = 128, block_k: int = 32) -> torch.Tensor:
    """x: [B, H, W, Cin] (Conv1 output), w_pc: [KH, KW, Cin, N] HWIO,
    b_pc: [N], w_cc: [I, J*D, C] -> v: [B, J*D].

    The PrimaryCaps conv (im2col GEMM + bias + per-capsule squash) and
    the votes + routing of the next layer, with u kept on chip."""
    kh, kw, cin, n_ch = w_pc.shape
    patches = im2col_patches(x, kh=kh, kw=kw, stride=stride)
    return primary_routing_patches(
        patches, w_pc.reshape(kh * kw * cin, n_ch), b_pc, w_cc, iters=iters,
        num_classes=num_classes, mode=mode, block_i=block_i, block_k=block_k)
