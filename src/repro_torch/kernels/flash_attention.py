"""Blocked online-softmax (flash) attention (K15).

The counterpart of ``repro/kernels/flash_attention.py``'s
``_flash_kernel``: causal masking, a sliding window (Gemma local layers),
logit softcapping (Gemma-2) and decode end-alignment, fp32 statistics.
The port's kernel (``csrc/flash_attention.cu``) adds what the model's
attention needs so that it runs on the model's tensors as they lie:

* **layout** -- q, o ``[B, Tq, H, D]`` and k, v ``[B, Tk, KvH, D]`` as
  strided views (last dim contiguous): the model's projections and its
  ``[B, S, KvH, D]`` cache go in without a transpose or a copy;
* **GQA by index** -- query head ``h`` reads KV head ``h // (H / KvH)``,
  the reference's ``q5`` grouping (``models/attention.py``); with
  ``KvH = H`` it is exactly the reference kernel;
* **per-row KV length** -- ``kv_len`` (int32 ``[B]``): row ``b`` sees keys
  ``0 .. kv_len[b] - 1`` with ``q_offset = kv_len[b] - Tq``, so one launch
  serves an engine's slots at different lengths.  ``None`` is ``Tk`` for
  every row: the reference kernel's function.  ``kv_len`` is clamped to
  ``0 .. Tk``; a row of no keys (``kv_len <= 0``) returns 0.

Masked logits are ``-1e30`` as in the reference, not ``-inf``: a row with
no valid key (a query before the keys' start under ``causal``, only when
``Tq > kv_len``) weighs every one of its keys alike and returns the mean
of V over them, in the kernel, the twin and the reference alike.

``flash_attention`` runs ``flash_attention_plain`` (the direct softmax
form, same GQA, ``kv_len`` and mask rules) for CPU tensors and the CUDA
kernel for CUDA tensors.  The KV tile comes from the shared-memory budget
and the SM's occupancy (``plan_tiles``).  Forward only: on the card the
wrapper refuses inputs that require grad, as the reference has no
backward kernel either.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.execplan import PlanError
from repro_torch.core.planner import ELEM_BYTES, SMEM_BYTES
from repro_torch.kernels.build import (Kernel, on_cpu, ptr, refuse_grad,
                                       stream_of)

NEG_INF = -1e30                  # the reference's masked logit
BLOCK_Q = 64                     # csrc/flash_attention.cu kBQ
BLOCK_K_CHOICES = (64, 32)       # the KV tiles the library is built for
SM_SMEM_BYTES = 233_472          # shared memory of one H100 SM (228 KB)
CTA_RESERVED_BYTES = 1_024       # the runtime's share of it per CTA
# 256 threads at up to 128 registers (ptxas, D = 256): the register file
# (65,536) holds two such CTAs, so more shared memory buys no third.
MAX_RESIDENT = 2
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (q/o type, k/v type) pairs the library is built for: one model type, or
# an fp32 model reading a bf16 cache in place.
PAIRS = {(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
         (torch.bfloat16, torch.bfloat16)}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
FLASH = Kernel("flash_attention", "flash_attention",
               [_I, _I, _P, _P, _P, _P, _P] + [_L] * 12 + [_I] * 6
               + [_F, _F, _I, _I, _I, _P])


def smem_bytes(head_dim: int, block_k: int) -> int:
    """One CTA's shared memory: the Q tile and the K tile, both stored
    transposed and padded by a column, the V tile, the probabilities."""
    floats = (head_dim * (BLOCK_Q + 1) + head_dim * (block_k + 1)
              + block_k * head_dim + BLOCK_Q * (block_k + 1))
    return floats * ELEM_BYTES


def resident_ctas(head_dim: int, block_k: int,
                  sm_smem: int = SM_SMEM_BYTES) -> int:
    """CTAs of this tile one SM holds at once, by shared memory and by
    the register file's ``MAX_RESIDENT``."""
    per_cta = smem_bytes(head_dim, block_k) + CTA_RESERVED_BYTES
    return min(MAX_RESIDENT, sm_smem // per_cta)


@functools.lru_cache(maxsize=32)
def plan_tiles(head_dim: int, smem_budget: int = SMEM_BYTES
               ) -> tuple[int, int]:
    """(block_q, block_k) at this head dim: of the KV tiles whose footprint
    fits one CTA's shared memory, the one an SM holds most CTAs of, and
    of those the widest.  At D = 128 the 32-key tile (75,008 B) lets two CTAs
    share an SM where the 64-key tile (115,968 B) allows one; at D = 256 one CTA
    fits either way and at D <= 64 the registers cap both at two, so the
    64-key tile wins.  The reference's 128 x 128 fp32 tiles at D = 256
    would need 128 KB for Q alone, with K and V as much again: they do
    not carry over from VMEM."""
    if head_dim not in HEAD_DIMS:
        raise PlanError(f"flash_attention: head_dim {head_dim} not among "
                        f"the kernel's {HEAD_DIMS}")
    fits = [bk for bk in BLOCK_K_CHOICES
            if smem_bytes(head_dim, bk) <= smem_budget]
    if not fits:
        raise PlanError(
            f"flash_attention: no KV tile fits {smem_budget} B of shared "
            f"memory at head_dim {head_dim} (the smallest takes "
            f"{smem_bytes(head_dim, BLOCK_K_CHOICES[-1])} B)")
    return BLOCK_Q, max(fits, key=lambda bk: (resident_ctas(head_dim, bk),
                                              bk))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, kv_len: torch.Tensor | None = None,
                          causal: bool = True, window: int | None = None,
                          softcap: float | None = None,
                          scale: float | None = None) -> torch.Tensor:
    """The direct softmax form of K15: q [B, Tq, H, D], k/v [B, Tk, KvH, D]
    -> [B, Tq, H, D] in q's type, fp32 logits and probabilities."""
    b, tq, h, d = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    scale = (d ** -0.5) if scale is None else scale
    q5 = q.float().reshape(b, tq, kvh, h // kvh, d)
    logits = torch.einsum("btkgd,bskd->bkgts", q5, k.float()) * scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    lens = (torch.full((b,), tk, device=q.device) if kv_len is None
            else kv_len.to(device=q.device, dtype=torch.long).clamp(0, tk))
    pos = (lens - tq)[:, None] + torch.arange(tq, device=q.device)[None]
    key = torch.arange(tk, device=q.device)[None, None]
    mask = torch.ones((b, tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= key <= pos[..., None]
    if window is not None:
        mask &= key > pos[..., None] - window
    logits = torch.where(mask[:, None, None], logits, NEG_INF)
    # Keys past a row's length are not the row's: they weigh exactly 0.
    mine = (key[0] < lens[:, None])[:, None, None, None]
    logits = torch.where(mine, logits, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", p, v.float())
    # A row of no keys softmaxes over -inf alone: it returns 0, not NaN.
    out = torch.where((lens == 0)[:, None, None, None, None], 0.0, out)
    return out.reshape(b, tq, h, d).to(q.dtype)


def _check(q, k, v, kv_len, window, out) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q [B, Tq, H, D] and k, v "
                         f"[B, Tk, KvH, D] expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d or h % k.shape[2]:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"fit q {tuple(q.shape)} (batch, head dim, or "
                         f"heads not a multiple of KV heads)")
    if kv_len is not None and (kv_len.shape != (b,)
                               or kv_len.dtype != torch.int32
                               or not kv_len.is_contiguous()):
        raise ValueError(f"flash_attention: kv_len must be contiguous int32 "
                         f"[{b}], got {kv_len.dtype} {tuple(kv_len.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got "
                         f"{window}")
    if out is not None and (out.shape != q.shape or out.dtype != q.dtype):
        raise ValueError(f"flash_attention: out {out.dtype} "
                         f"{tuple(out.shape)}, expected {q.dtype} "
                         f"{tuple(q.shape)}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    kv_len: torch.Tensor | None = None, causal: bool = True,
                    window: int | None = None, softcap: float | None = None,
                    scale: float | None = None,
                    out: torch.Tensor | None = None,
                    block_k: int | None = None) -> torch.Tensor:
    """K15: q [B, Tq, H, D], k/v [B, Tk, KvH, D] (strided views with a
    contiguous last dim) -> [B, Tq, H, D] in q's type, written into
    ``out`` when given (any strides, last dim contiguous).  ``block_k``
    is ``plan_tiles``' pick unless given (one of ``BLOCK_K_CHOICES``)."""
    _check(q, k, v, kv_len, window, out)
    kw = dict(kv_len=kv_len, causal=causal, window=window, softcap=softcap,
              scale=scale)
    tensors = [q, k, v] + ([kv_len] if kv_len is not None else [])
    if on_cpu("flash_attention", *tensors,
              dtypes=tuple(DTYPES) + (torch.int32,), contiguous=False):
        res = flash_attention_plain(q, k, v, **kw)
        return res if out is None else out.copy_(res)
    refuse_grad("flash_attention", q, k, v)
    if (q.dtype, k.dtype) not in PAIRS or v.dtype != k.dtype:
        raise TypeError(f"flash_attention: q {q.dtype} with k/v {k.dtype}, "
                        f"{v.dtype} is not among the kernel's pairs")
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if out.device != q.device:
        raise ValueError("flash_attention: out lies on another device")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name}'s last dim must be "
                             f"contiguous, strides {t.stride()}")
    b, tq, h, d = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    bk = plan_tiles(d)[1] if block_k is None else block_k
    if bk not in BLOCK_K_CHOICES:
        raise ValueError(f"flash_attention: block_k {bk} not among "
                         f"{BLOCK_K_CHOICES}")
    scale = (d ** -0.5) if scale is None else scale
    lens = ptr(kv_len) if kv_len is not None else None
    if tq and tk:
        FLASH(DTYPES[q.dtype], DTYPES[k.dtype], ptr(q), ptr(k), ptr(v),
              ptr(out), lens, *q.stride()[:3], *k.stride()[:3],
              *v.stride()[:3], *out.stride()[:3], b, h, kvh, tq, tk, d,
              scale, softcap if softcap is not None else 0.0, int(causal),
              window if window is not None else 0, bk, stream_of(q))
    return out
