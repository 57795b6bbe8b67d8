"""im2col convolution kernels and their backward.

The counterparts of ``repro/kernels/conv_im2col.py``: K1 patch extraction
(``im2col_patches``) and the K2 tiled GEMM (``matmul_bias_act``) in
``csrc/conv_im2col.cu``; K6 ``matmul_at_b`` (dW) and K7 ``col2im_patches``
(dx) in ``csrc/conv_bwd.cu``; and ``conv2d_im2col``, the differentiable
conv whose ``torch.autograd.Function`` runs K1+K2 forward and
K1/K2/K6/K7 backward, as the reference's ``_conv_core`` custom VJP does.
Each wrapper runs its plain PyTorch twin for CPU tensors and launches its
CUDA kernel for CUDA tensors; see the sources for the design and what
bounds each kernel on the H100.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.planner import TILE_MN, at_b_splits, gemm_tile_n
from repro_torch.kernels import ref
from repro_torch.kernels.build import Kernel, on_cpu, ptr, stream_of

EPILOGUES = ("none", "relu", "squash")

_P, _I = ctypes.c_void_p, ctypes.c_int
PATCHES = Kernel("conv_im2col", "im2col_patches_f32",
                 [_P, _P] + [_I] * 7 + [_P])
GEMM = Kernel("conv_im2col", "matmul_bias_act_f32",
              [_P] * 4 + [_I] * 9 + [_P])
AT_B = Kernel("conv_bwd", "matmul_at_b_f32", [_P] * 4 + [_I] * 5 + [_P])
COL2IM = Kernel("conv_bwd", "col2im_patches_f32", [_P, _P] + [_I] * 7 + [_P])


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


def matmul_at_b_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a^T @ b`` as K6 computes it: the M axis cut into the kernel's
    splits (``planner.at_b_splits``), one partial product per split, the
    partials summed in split order."""
    m, k = a.shape
    _, rows = at_b_splits(m, k, b.shape[1])
    out = None
    for r0 in range(0, m, rows):
        part = a[r0:r0 + rows].t() @ b[r0:r0 + rows]
        out = part if out is None else out + part
    return out


def matmul_at_b(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K6: a [M, K], b [M, N] -> a^T @ b [K, N] (the backward's dW),
    without a transpose in device memory."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0] \
            or a.shape[0] < 1:
        raise ValueError(f"matmul_at_b: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must be [M, K] and [M, N], "
                         f"M >= 1")
    m, k = a.shape
    n = b.shape[1]
    if on_cpu("matmul_at_b", a, b):
        return matmul_at_b_plain(a, b)
    splits, rows = at_b_splits(m, k, n)
    out = torch.empty((k, n), dtype=a.dtype, device=a.device)
    partial = (torch.empty((splits, k, n), dtype=a.dtype, device=a.device)
               if splits > 1 else out)
    AT_B(ptr(a), ptr(b), ptr(out), ptr(partial), m, k, n, splits, rows,
         stream_of(a))
    return out


def col2im_patches_plain(dp: torch.Tensor, *, kh: int, kw: int, stride: int,
                         h: int, w: int) -> torch.Tensor:
    """dp [B, OH*OW, KH*KW*C] -> dx [B, H, W, C]: each kernel tap's
    cotangent slab added back onto the strided positions K1 sliced it
    from (the reference's ``_col2im_kernel``)."""
    bsz = dp.shape[0]
    c = dp.shape[2] // (kh * kw)
    oh, ow = out_size(h, kh, stride), out_size(w, kw, stride)
    taps = dp.reshape(bsz, oh, ow, kh * kw, c)
    dx = torch.zeros((bsz, h, w, c), dtype=dp.dtype, device=dp.device)
    for i in range(kh):
        for j in range(kw):
            dx[:, i:i + (oh - 1) * stride + 1:stride,
               j:j + (ow - 1) * stride + 1:stride, :] += taps[:, :, :,
                                                               i * kw + j]
    return dx


def col2im_patches(dp: torch.Tensor, *, kh: int, kw: int, stride: int,
                   h: int, w: int) -> torch.Tensor:
    """K7: the exact transpose of K1, dp [B, OH*OW, KH*KW*C] ->
    dx [B, H, W, C]; a gather on CUDA (each dx element sums the windows
    that cover it), so it needs no atomics."""
    oh, ow = out_size(h, kh, stride), out_size(w, kw, stride)
    if dp.dim() != 3 or oh < 1 or ow < 1 or dp.shape[1] != oh * ow \
            or dp.shape[2] % (kh * kw):
        raise ValueError(f"col2im_patches: dp {tuple(dp.shape)} is not the "
                         f"patch matrix of a {kh}x{kw}/{stride} window over "
                         f"{h}x{w}")
    bsz = dp.shape[0]
    c = dp.shape[2] // (kh * kw)
    if on_cpu("col2im_patches", dp):
        return col2im_patches_plain(dp, kh=kh, kw=kw, stride=stride, h=h,
                                    w=w)
    dx = torch.empty((bsz, h, w, c), dtype=dp.dtype, device=dp.device)
    COL2IM(ptr(dp), ptr(dx), bsz, h, w, c, kh, kw, stride, stream_of(dp))
    return dx


# ---------------------------------------------------------------------------
# conv2d_im2col: forward K1 + K2, backward K1 / K2 / K6 / K7
# ---------------------------------------------------------------------------

class ConvStatics(NamedTuple):
    """The schedule of one conv: the forward GEMM's tiles (reused by the
    backward's pre-activation recompute) and the dpatches GEMM's."""

    stride: int
    block: tuple[int, int, int]          # (block_m, block_k, block_n)
    dx_block: tuple[int, int, int]
    epilogue: str
    squash_dim: int


def _geometry(st: ConvStatics, x: torch.Tensor, w: torch.Tensor):
    b, h, w_hw, _ = x.shape
    kh, kw, cin, cout = w.shape
    oh, ow = out_size(h, kh, st.stride), out_size(w_hw, kw, st.stride)
    return b * oh * ow, kh * kw * cin, cout, oh, ow


def gemm_tiles(block: tuple[int, int, int], p2, w2, bias,
               **kw) -> torch.Tensor:
    """``matmul_bias_act`` on ``block = (block_m, block_k, block_n)``."""
    bm, bk, bn = block
    return matmul_bias_act(p2, w2, bias, block_m=bm, block_k=bk, block_n=bn,
                           **kw)


def conv_bwd_from_dpre(dpre: torch.Tensor, p2: torch.Tensor | None,
                       w: torch.Tensor, *, stride: int,
                       dx_block: tuple[int, int, int], x_shape,
                       need: tuple[bool, bool, bool]):
    """(dx, dW, dbias) of a conv from the cotangent of its pre-activation
    ``dpre [M, Cout]``: dbias sums it, K6 gives dW = patches^T dpre (``p2``
    the [M, K] patches, needed only for dW), K2 on ``dx_block`` tiles
    dpatches = dpre W^T, and K7 dx.  ``need`` = (dx, dW, dbias); what is
    not needed is None."""
    need_x, need_w, need_b = need
    kh, kw, cin, cout = w.shape
    kk = kh * kw * cin
    dx = dw = dbias = None
    if need_b:
        dbias = dpre.sum(0)
    if need_w:
        dw = matmul_at_b(p2, dpre).reshape(w.shape)
    if need_x:
        bsz, h, w_hw = x_shape[:3]
        dpatches = gemm_tiles(dx_block, dpre,
                              w.reshape(kk, cout).t().contiguous(),
                              torch.zeros(kk, dtype=dpre.dtype,
                                          device=dpre.device))
        dx = col2im_patches(dpatches.reshape(bsz, -1, kk), kh=kh, kw=kw,
                            stride=stride, h=h, w=w_hw)
    return dx, dw, dbias


class _Conv(torch.autograd.Function):
    """The reference's ``_conv_core`` custom VJP.  Saves ``(x, w, bias)``,
    plus the output for the ReLU mask only; the backward recomputes the
    patches (K1) and, for the fused squash, the pre-activation (K2)."""

    @staticmethod
    def forward(ctx, x, w, bias, st: ConvStatics):
        m, kk, cout, oh, ow = _geometry(st, x, w)
        kh, kw = w.shape[:2]
        patches = im2col_patches(x, kh=kh, kw=kw, stride=st.stride)
        out = gemm_tiles(st.block, patches.reshape(m, kk), w.reshape(kk, cout),
                    bias, epilogue=st.epilogue, squash_dim=st.squash_dim)
        out = out.reshape(x.shape[0], oh, ow, cout)
        ctx.st = st
        ctx.save_for_backward(x, w, bias,
                              out if st.epilogue == "relu" else None)
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w, bias, out = ctx.saved_tensors
        st = ctx.st
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        m, kk, cout, _, _ = _geometry(st, x, w)
        kh, kw = w.shape[:2]
        w2 = w.reshape(kk, cout)
        dy2 = dy.reshape(m, cout).contiguous()
        p2 = None
        if need_w or st.epilogue == "squash":
            p2 = im2col_patches(x, kh=kh, kw=kw,
                                stride=st.stride).reshape(m, kk)
        if st.epilogue == "relu":
            dpre = dy2 * (out.reshape(m, cout) > 0)
        elif st.epilogue == "squash":
            sd = st.squash_dim
            pre = gemm_tiles(st.block, p2, w2, bias)
            dpre = ref.squash_vjp(pre.reshape(m, cout // sd, sd),
                                  dy2.reshape(m, cout // sd, sd)
                                  ).reshape(m, cout)
        else:
            dpre = dy2
        dx, dw, dbias = conv_bwd_from_dpre(
            dpre, p2, w, stride=st.stride, dx_block=st.dx_block,
            x_shape=x.shape, need=(need_x, need_w, need_b))
        return dx, dw, dbias, None


def conv2d_im2col(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, *,
                  stride: int = 1,
                  block: tuple[int, int, int] = (64, 16, 64),
                  dx_block: tuple[int, int, int] = (64, 16, 64),
                  epilogue: str = "none",
                  squash_dim: int = 0) -> torch.Tensor:
    """VALID conv as an im2col GEMM: x [B,H,W,Cin], w [KH,KW,Cin,Cout]
    HWIO -> epilogue(conv(x, w) + bias) [B, OH, OW, Cout].

    Differentiable: the backward runs K6 (dW = patches^T dpre), K2 with
    ``dx_block`` tiles (dpatches = dpre W^T) and K7 (dx), skipping what
    no input asks for.  Tiles come from the ExecutionPlan (``ops``)."""
    if x.dim() != 4 or w.dim() != 4 or w.shape[2] != x.shape[3]:
        raise ValueError(f"conv2d_im2col: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} must be NHWC and HWIO with "
                         f"matching channels")
    st = ConvStatics(stride=stride, block=tuple(block),
                     dx_block=tuple(dx_block), epilogue=epilogue,
                     squash_dim=squash_dim)
    return _Conv.apply(x, w, bias, st)
