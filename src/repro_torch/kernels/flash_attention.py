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
kernel for CUDA tensors, in one of two schedules:

* **decode** -- where the ``Tq * H / KvH`` query rows that read one KV
  head are few (at most ``decode_rows(D)``: 8 at D = 256, 16 below), one
  CTA takes one (batch row, KV head, key split) and all those rows, so K
  and V are read once per KV head; a second kernel merges the splits'
  partials in split order.  ``plan_decode`` fixes the split count from
  the shapes alone (never from ``kv_len``'s values, which would cost a
  device-to-host copy a layer); ``flash_decode_plain`` is its twin, the
  same partials and combine in PyTorch;
* **prefill** -- every other call: one CTA per (batch row, query head,
  64-row q block) with K/V tiles of ``block_k`` keys streaming through a
  two-stage ``cp.async`` ring.  The tile comes from the shared-memory and
  register budgets (``plan_tiles``).

Head dims: 16, 32, 64, 80, 128 and 256 in prefill (80 is hubert's: 16
heads of 80); the decode schedule is built for every one but 80, where
the plan refuses it by name (``plan_decode``, ``schedule``) and a call
with few query rows takes the prefill schedule, which serves any Tq.

Both run in IEEE fp32 on CUDA cores; one call is one counted launch.
Forward only: on the card the wrapper refuses inputs that require grad,
as the reference has no backward kernel either.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core.execplan import PlanError
from repro_torch.core.planner import ELEM_BYTES, NUM_SMS, SMEM_BYTES
from repro_torch.kernels.build import (Kernel, on_cpu, ptr, refuse_grad,
                                       stream_of)

NEG_INF = -1e30                  # the reference's masked logit
BLOCK_Q = 64                     # csrc/flash_attention.cu kBQ
BLOCK_K_CHOICES = (64, 32)       # the KV tiles the library is built for
PREFILL_STAGES = 2               # kStages: the K/V ring
SM_SMEM_BYTES = 233_472          # shared memory of one H100 SM (228 KB)
CTA_RESERVED_BYTES = 1_024       # the runtime's share of it per CTA
# Registers cap how many 256-thread prefill CTAs an SM holds: at D = 256
# a thread's 8 x 8 output block and 4 x 4 logits take 220 registers
# (ptxas, fp32), one CTA's worth (__launch_bounds__(256, 1)); below, the
# kernel is held to 128 registers so that two CTAs fit the register file
# (65,536), at a spill of up to 56 B a thread.
MAX_RESIDENT = {256: 1}
MAX_RESIDENT_DEFAULT = 2
HEAD_DIMS = (16, 32, 64, 80, 128, 256)
# The decode kernel's lanes split D / 4 float4 chunks of a key by powers
# of two: D = 80 (20 chunks) has no decode schedule.
DECODE_HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# (q/o type, k/v type) pairs the library is built for: one model type, or
# an fp32 model reading a bf16 cache in place.
PAIRS = {(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
         (torch.bfloat16, torch.bfloat16)}
# Decode: a CTA's query rows are padded to one of these (kernel template
# RB); a lane holds RB x max(4, D / 32) accumulators, at most 64.
DECODE_ROW_BUCKETS = (2, 4, 8, 16)
DECODE_STAGES = 4                # kDecStages: a lane's cp.async ring
DECODE_WAVES = 2                 # CTAs an SM, aimed for by plan_decode
DECODE_MIN_KEYS = 64             # the shortest split plan_decode makes
WARPS = 8

# Launches of FLASH by schedule (each also counts once in FLASH.launches).
SCHEDULE_LAUNCHES = {"prefill": 0, "decode": 0}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
FLASH = Kernel("flash_attention", "flash_attention",
               [_I, _I, _P, _P, _P, _P, _P] + [_L] * 12 + [_I] * 6
               + [_F, _F, _I, _I, _I, _I, _I, _P, _P])


def smem_bytes(head_dim: int, block_k: int, kv_bytes: int = ELEM_BYTES
               ) -> int:
    """One prefill CTA's shared memory: the fp32 Q tile (rows padded by
    32 B), ``PREFILL_STAGES`` stages of K (rows padded by 16 B) and V in
    their own type, the transposed probabilities, and alpha and l by
    row."""
    q = BLOCK_Q * (head_dim + 8) * ELEM_BYTES
    kv = block_k * (2 * head_dim * kv_bytes + 16)
    p = block_k * (BLOCK_Q + 4) * ELEM_BYTES
    return q + PREFILL_STAGES * kv + p + 2 * BLOCK_Q * ELEM_BYTES


def resident_ctas(head_dim: int, block_k: int,
                  sm_smem: int = SM_SMEM_BYTES) -> int:
    """Prefill CTAs of this tile one SM holds at once, by shared memory
    and by the register file (``MAX_RESIDENT``)."""
    per_cta = smem_bytes(head_dim, block_k) + CTA_RESERVED_BYTES
    return min(MAX_RESIDENT.get(head_dim, MAX_RESIDENT_DEFAULT),
               sm_smem // per_cta)


@functools.lru_cache(maxsize=32)
def plan_tiles(head_dim: int, smem_budget: int = SMEM_BYTES
               ) -> tuple[int, int]:
    """(block_q, block_k) of the prefill schedule at this head dim: of the
    KV tiles whose fp32 footprint fits one CTA's shared memory, the one an
    SM holds most CTAs of, and of those the widest.  At D = 256 only the
    32-key tile fits (208,896 B: Q, two K/V stages, P); at D = 128 the
    32-key tile (110,592 B) lets two CTAs share an SM where the 64-key one
    (185,856 B) allows one, and so at D = 80 (73,728 B against 124,416 B);
    at D <= 64 the registers cap both at two, so the 64-key tile wins.
    The reference's 128 x 128 fp32 tiles at D = 256 would need 128 KB for
    Q alone, with K and V as much again: they do not carry over from
    VMEM."""
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


def decode_rows(head_dim: int) -> int:
    """The most query rows (``Tq * H / KvH``) a decode CTA takes: its
    lanes hold rows x max(4, D / 32) accumulators, at most 64."""
    return 8 if head_dim > 128 else 16


def decode_smem_bytes(head_dim: int, rows: int,
                      kv_bytes: int = ELEM_BYTES) -> int:
    """One decode CTA's shared memory at ``rows`` (a bucket) query rows:
    their fp32 q, then the larger of the lanes' cp.async rings (K and V
    slices, ``DECODE_STAGES`` stages) and the warps' partials they give
    way to, then the warps' (m, l)."""
    lanes = min(32, head_dim // 4)
    chunks = head_dim // (4 * lanes)
    ring = DECODE_STAGES * 2 * chunks * 256 * 4 * kv_bytes
    merge = WARPS * rows * head_dim * ELEM_BYTES
    return (rows * head_dim * ELEM_BYTES + max(ring, merge)
            + WARPS * rows * 2 * ELEM_BYTES)


def split_keys(tk: int, splits: int) -> tuple[int, int]:
    """(splits, chunk): ``tk`` keys in splits of ``chunk`` keys, none of
    them empty (so fewer splits than asked where ``tk`` is short)."""
    chunk = -(-tk // max(1, splits))
    return -(-tk // chunk), chunk


@functools.lru_cache(maxsize=64)
def plan_decode(batch: int, kv_heads: int, rows: int, tk: int,
                head_dim: int) -> int | None:
    """Key splits of the decode schedule, or None where the call is a
    prefill (more than ``decode_rows`` query rows a KV head).  From the
    shapes alone -- ``tk`` is the cache's capacity -- never from the rows'
    key counts: enough splits that ``batch * kv_heads * splits`` CTAs fill
    ``DECODE_WAVES`` CTAs an SM, none shorter than ``DECODE_MIN_KEYS``
    keys, none empty when every row holds ``tk`` keys.  Splits past a
    row's ``kv_len`` exit at once.  A head dim with no decode kernel
    (``DECODE_HEAD_DIMS``) raises ``PlanError`` where the call would be
    a decode."""
    if rows > decode_rows(head_dim):
        return None
    if head_dim not in DECODE_HEAD_DIMS:
        raise PlanError(f"flash_attention: no decode schedule at head_dim "
                        f"{head_dim} (built for {DECODE_HEAD_DIMS}); its "
                        f"calls take the prefill schedule")
    want = -(-DECODE_WAVES * NUM_SMS // (batch * kv_heads))
    most = max(1, tk // DECODE_MIN_KEYS)
    return split_keys(tk, min(want, most))[0]


class Schedule(NamedTuple):
    """A K15 call's schedule: ``decode`` over ``splits`` key splits of
    ``chunk`` keys, or ``prefill`` on ``block_k``-key tiles."""
    kind: str
    splits: int = 0
    chunk: int = 0
    block_k: int = 0

    def __str__(self) -> str:
        return (f"decode, {self.splits} splits" if self.kind == "decode"
                else f"prefill, block_k {self.block_k}")


def schedule(q: torch.Tensor, k: torch.Tensor, *, block_k: int | None = None,
             splits: int | None = None) -> Schedule:
    """The schedule ``flash_attention`` launches on the card for these q
    [B, Tq, H, D] and k [B, Tk, KvH, D], from their shapes alone:
    ``plan_decode``'s splits, else prefill on ``plan_tiles``' tile.
    ``splits`` (decode) or ``block_k`` (prefill: one of
    ``BLOCK_K_CHOICES`` that fits a CTA) overrides the plan, for sweeps
    and tests; not both.  At a head dim with no decode kernel every call
    is a prefill, and ``splits`` raises ``PlanError``."""
    if block_k is not None and splits is not None:
        raise ValueError("flash_attention: block_k (prefill) and splits "
                         "(decode) name two schedules; give one")
    b, tq, h, d = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise PlanError(f"flash_attention: head_dim {d} not among the "
                        f"kernel's {HEAD_DIMS}")
    rows = tq * (h // kvh)
    if d not in DECODE_HEAD_DIMS:
        if splits is not None:
            raise PlanError(f"flash_attention: no decode schedule at "
                            f"head_dim {d} (built for {DECODE_HEAD_DIMS})")
    elif splits is None and block_k is None:
        splits = plan_decode(b, kvh, rows, tk, d)
    if splits is not None:
        if rows > decode_rows(d) or splits < 1:
            raise ValueError(f"flash_attention: the decode schedule takes "
                             f"at most {decode_rows(d)} query rows a KV "
                             f"head at D = {d} and splits >= 1, got "
                             f"{rows} rows, {splits} splits")
        splits, chunk = split_keys(tk, splits)
        return Schedule("decode", splits=splits, chunk=chunk)
    bk = plan_tiles(d)[1] if block_k is None else block_k
    if (bk not in BLOCK_K_CHOICES
            or smem_bytes(d, bk, k.element_size()) > SMEM_BYTES):
        raise ValueError(f"flash_attention: block_k {bk} is not a tile "
                         f"of {BLOCK_K_CHOICES} that fits a CTA at "
                         f"D = {d} ({k.dtype} K/V)")
    return Schedule("prefill", block_k=bk)


def _masked_logits(q, k, kv_len, causal, window, softcap, scale):
    """Both twins' fp32 logits ``[B, KvH, G, Tq, Tk]`` (softcapped, -1e30
    where causal or the window masks a key), the rows' key counts
    (``kv_len`` clamped to 0 .. Tk) and the keys' indices."""
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
    key = torch.arange(tk, device=q.device)
    mask = torch.ones((b, tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= key <= pos[..., None]
    if window is not None:
        mask &= key > pos[..., None] - window
    return torch.where(mask[:, None, None], logits, NEG_INF), lens, key


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, kv_len: torch.Tensor | None = None,
                          causal: bool = True, window: int | None = None,
                          softcap: float | None = None,
                          scale: float | None = None) -> torch.Tensor:
    """The direct softmax form of K15: q [B, Tq, H, D], k/v [B, Tk, KvH, D]
    -> [B, Tq, H, D] in q's type, fp32 logits and probabilities."""
    logits, lens, key = _masked_logits(q, k, kv_len, causal, window,
                                       softcap, scale)
    # Keys past a row's length are not the row's: they weigh exactly 0.
    mine = (key < lens[:, None])[:, None, None, None]
    logits = torch.where(mine, logits, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", p, v.float())
    # A row of no keys softmaxes over -inf alone: it returns 0, not NaN.
    out = torch.where((lens == 0)[:, None, None, None, None], 0.0, out)
    return out.reshape(q.shape).to(q.dtype)


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, splits: int, kv_len: torch.Tensor | None = None,
                       causal: bool = True, window: int | None = None,
                       softcap: float | None = None,
                       scale: float | None = None) -> torch.Tensor:
    """The decode schedule of K15 in PyTorch: the keys in ``splits``
    splits (``split_keys``), each split's partial ``(m, l, acc)`` over the
    keys its CTA visits (those of ``[0, kv_len)`` that some row of the
    batch row can see -- all of them where a row has no valid key), then
    the partials merged in split order, empty ones (``m = -inf``) weighing
    nothing.  Same shapes and result as ``flash_attention_plain``."""
    b, tq, h, d = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    splits, chunk = split_keys(tk, splits)
    logits, lens, key = _masked_logits(q, k, kv_len, causal, window,
                                       softcap, scale)
    # The CTA's keys: [lo, kv_len), lo from the first row's window, unless
    # a row has no valid key (then every key of the row).
    lo = torch.zeros_like(lens)
    if window is not None:
        lo = (lens - tq - window + 1).clamp(min=0)
        if causal:
            lo = torch.where(lens - tq < 0, 0, lo)
    seen = (key >= lo[:, None]) & (key < lens[:, None])
    logits = torch.where(seen[:, None, None, None], logits, float("-inf"))
    pad = splits * chunk - tk
    logits = torch.nn.functional.pad(logits, (0, pad), value=float("-inf"))
    logits = logits.reshape(*logits.shape[:-1], splits, chunk)
    vs = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    vs = vs.reshape(b, splits, chunk, kvh, d)
    m = logits.amax(-1)                               # [b, k, g, t, S]
    p = torch.exp(logits - torch.where(m == float("-inf"), 0.0, m)[..., None])
    part_l = p.sum(-1)
    part_acc = torch.einsum("bkgtsc,bsckd->bkgtsd", p, vs)
    top = m.amax(-1, keepdim=True)
    w = torch.where(m == float("-inf"), 0.0,
                    torch.exp(m - torch.where(top == float("-inf"), 0.0,
                                              top)))
    total = (part_l * w).sum(-1)
    out = (part_acc * w[..., None]).sum(-2)
    out = torch.where(total[..., None] == 0, 0.0,
                      out / torch.where(total == 0, 1.0, total)[..., None])
    return out.permute(0, 3, 1, 2, 4).reshape(b, tq, h, d).to(q.dtype)


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
                    block_k: int | None = None,
                    splits: int | None = None) -> torch.Tensor:
    """K15: q [B, Tq, H, D], k/v [B, Tk, KvH, D] (strided views with a
    contiguous last dim) -> [B, Tq, H, D] in q's type, written into
    ``out`` when given (any strides, last dim contiguous).  On the card
    it launches ``schedule(q, k)``'s schedule; ``block_k`` and ``splits``
    are ``schedule``'s overrides, for sweeps and tests.  On CPU tensors
    it gives the direct form."""
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
    sched = schedule(q, k, block_k=block_k, splits=splits)
    b, tq, h, d = q.shape
    tk, kvh = k.shape[1], k.shape[2]
    ws = None
    if sched.kind == "decode" and tq and tk:
        ws = torch.empty(b * h * tq * sched.splits * (d + 2),
                         dtype=torch.float32, device=q.device)
    scale = (d ** -0.5) if scale is None else scale
    lens = ptr(kv_len) if kv_len is not None else None
    if tq and tk:
        FLASH(DTYPES[q.dtype], DTYPES[k.dtype], ptr(q), ptr(k), ptr(v),
              ptr(out), lens, *q.stride()[:3], *k.stride()[:3],
              *v.stride()[:3], *out.stride()[:3], b, h, kvh, tq, tk, d,
              scale, softcap if softcap is not None else 0.0, int(causal),
              window if window is not None else 0, sched.block_k,
              sched.splits, sched.chunk,
              ptr(ws) if ws is not None else None, stream_of(q))
        SCHEDULE_LAUNCHES[sched.kind] += 1
    return out
