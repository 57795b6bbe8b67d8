"""im2col convolution kernels: K1 patch extraction and the K2 tiled GEMM.

The counterparts of ``repro/kernels/conv_im2col.py``'s ``im2col_patches``
and ``matmul_bias_act`` (forward only).  Each wrapper runs its plain
PyTorch twin for CPU tensors and launches its CUDA kernel
(``csrc/conv_im2col.cu``) for CUDA tensors; see that file for the design
and what bounds it on the H100.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.planner import TILE_MN, gemm_tile_n
from repro_torch.kernels import ref
from repro_torch.kernels.build import Kernel, on_cpu, ptr, stream_of

EPILOGUES = ("none", "relu", "squash")

_P, _I = ctypes.c_void_p, ctypes.c_int
PATCHES = Kernel("conv_im2col", "im2col_patches_f32",
                 [_P, _P] + [_I] * 7 + [_P])
GEMM = Kernel("conv_im2col", "matmul_bias_act_f32",
              [_P] * 4 + [_I] * 9 + [_P])


def out_size(size: int, k: int, stride: int) -> int:
    return (size - k) // stride + 1


def im2col_patches_plain(x: torch.Tensor, *, kh: int, kw: int,
                         stride: int = 1) -> torch.Tensor:
    """x: [B, H, W, C] -> patches [B, OH*OW, KH*KW*C] (VALID), with
    ``(kh, kw, c)``-major columns, matching ``w.reshape(KH*KW*C, Cout)``
    of an HWIO weight."""
    b, h, w, c = x.shape
    oh, ow = out_size(h, kh, stride), out_size(w, kw, stride)
    taps = [x[:, i:i + (oh - 1) * stride + 1:stride,
              j:j + (ow - 1) * stride + 1:stride, :]
            for i in range(kh) for j in range(kw)]       # [B, OH, OW, C] each
    return torch.stack(taps, dim=3).reshape(b, oh * ow, kh * kw * c)


def im2col_patches(x: torch.Tensor, *, kh: int, kw: int,
                   stride: int = 1) -> torch.Tensor:
    """K1: ``im2col_patches_plain`` for CPU tensors, the CUDA gather
    kernel for CUDA tensors."""
    if x.dim() != 4:
        raise ValueError(f"im2col_patches: x must be [B, H, W, C], got "
                         f"{tuple(x.shape)}")
    b, h, w, c = x.shape
    oh, ow = out_size(h, kh, stride), out_size(w, kw, stride)
    if oh < 1 or ow < 1:
        raise ValueError(f"im2col_patches: a {kh}x{kw} window does not fit "
                         f"a {h}x{w} image")
    if on_cpu("im2col_patches", x):
        return im2col_patches_plain(x, kh=kh, kw=kw, stride=stride)
    out = torch.empty((b, oh * ow, kh * kw * c), dtype=x.dtype,
                      device=x.device)
    PATCHES(ptr(x), ptr(out), b, h, w, c, kh, kw, stride, stream_of(x))
    return out


def matmul_bias_act_plain(p: torch.Tensor, w: torch.Tensor,
                          bias: torch.Tensor, *, epilogue: str = "none",
                          squash_dim: int = 0) -> torch.Tensor:
    """epilogue(p @ w + bias) with the reference's epilogues."""
    out = p @ w + bias
    if epilogue == "relu":
        out = torch.relu(out)
    elif epilogue == "squash":
        m, n = out.shape
        out = ref.squash(out.reshape(m, n // squash_dim,
                                     squash_dim)).reshape(m, n)
    return out


def matmul_bias_act(p: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *,
                    block_m: int = 64, block_k: int = 16, block_n: int = 64,
                    epilogue: str = "none",
                    squash_dim: int = 0) -> torch.Tensor:
    """K2: p [M, K], w [K, N], bias [N] -> epilogue(p @ w + bias) [M, N].

    ``epilogue="squash"`` squashes every ``squash_dim`` consecutive
    output channels as one capsule, which needs ``block_n`` and N to be
    multiples of ``squash_dim`` so no capsule straddles a tile.  On CUDA
    ``block_m`` must be one of ``planner.TILE_MN`` and ``block_n`` at
    most its widest entry.
    """
    if epilogue not in EPILOGUES:
        raise ValueError(f"unknown epilogue {epilogue!r}")
    if p.dim() != 2 or w.dim() != 2 or p.shape[1] != w.shape[0] \
            or bias.shape != (w.shape[1],):
        raise ValueError(f"matmul_bias_act: shapes {tuple(p.shape)} x "
                         f"{tuple(w.shape)} + {tuple(bias.shape)} do not "
                         f"chain")
    m, k = p.shape
    n = w.shape[1]
    if epilogue == "squash" and (squash_dim < 1 or block_n % squash_dim
                                 or n % squash_dim):
        raise ValueError(
            f"squash epilogue needs a positive capsule dim dividing both "
            f"block_n ({block_n}) and N ({n}); got squash_dim={squash_dim}")
    if on_cpu("matmul_bias_act", p, w, bias):
        return matmul_bias_act_plain(p, w, bias, epilogue=epilogue,
                                     squash_dim=squash_dim)
    if block_m not in TILE_MN or block_k < 1:
        raise ValueError(f"matmul_bias_act: block_m={block_m} is not one of "
                         f"{TILE_MN}, or block_k={block_k} < 1")
    out = torch.empty((m, n), dtype=p.dtype, device=p.device)
    GEMM(ptr(p), ptr(w), ptr(bias), ptr(out), m, n, k, block_m,
         gemm_tile_n(block_n), block_n, block_k, EPILOGUES.index(epilogue),
         squash_dim, stream_of(p))
    return out
