"""Attention of the LM family: the GQA/MQA/MHA path of
``repro/models/attention.py`` (sliding window, softcap, bidirectional),
with KV caches for decode.

Decode cache (per layer): ``{"k": [B, S, KvH, Dh], "v": [B, S, KvH, Dh]}``
in attention layout, preallocated by ``init_cache``.  The reference's
functional ``_cache_update`` (a ``dynamic_update_slice``) becomes an
indexed write INTO the cache tensors: ``gqa_forward`` updates the cache
in place and returns the same dict.

``cache_index`` is a scalar (every row aligned) or a per-row vector
``[B]`` (the slot-based serving engine).  ``backend="torch"`` computes
``grouped_attention``, the reference's masked softmax over the whole
cache; ``backend="kernels"`` calls K15 (``ops.flash_attention``) on the
cache in place -- strided views, no transpose and no expanded KV heads --
with each row's key count ``kv_len = cache_index + T``.  What every layer
derives from the positions (rope tables, cache-write indices, ``kv_len``)
is computed once a forward, in ``AttnInputs``.

MLA (DeepSeek's latent attention) waits for its ROADMAP item.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, init_linear, rope_tables

NEG_INF = -1e30
MLA_TODO = ("MLA attention is not ported yet (ROADMAP queue 1, item 11c)")


def init_attn_params(generator: torch.Generator, cfg: ModelConfig,
                     dtype: torch.dtype, device: torch.device,
                     lead: tuple[int, ...] = ()) -> dict:
    if cfg.mla:
        raise NotImplementedError(MLA_TODO)
    d, dh = cfg.d_model, cfg.head_dim
    return {
        "q_proj": init_linear(generator, d, cfg.num_heads * dh, dtype,
                              device, lead),
        "k_proj": init_linear(generator, d, cfg.num_kv_heads * dh, dtype,
                              device, lead),
        "v_proj": init_linear(generator, d, cfg.num_kv_heads * dh, dtype,
                              device, lead),
        "o_proj": init_linear(generator, cfg.num_heads * dh, d, dtype,
                              device, lead),
    }


# ---------------------------------------------------------------------------
# Cache plumbing
# ---------------------------------------------------------------------------

def _cache_write(buf: torch.Tensor, val: torch.Tensor,
                 inputs: "AttnInputs") -> None:
    """Write ``val`` [B, T, ...] into ``buf`` [B, S, ...] at the forward's
    sequence position: an int (every row), or an int64 ``[B]`` tensor (one
    position per row, through ``inputs.scatter_index``)."""
    ci = inputs.cache_index
    if isinstance(ci, int):
        buf[:, ci:ci + val.shape[1]] = val
        return
    buf[inputs.scatter_index] = val.to(buf.dtype)


def _cache_positions(cache_index, b: int, s: int, t: int,
                     device) -> torch.Tensor:
    """kv positions [B, S] with unwritten slots marked -1."""
    end = torch.as_tensor(cache_index, device=device).reshape(-1)
    end = end.expand(b) if end.numel() == 1 else end
    idx = torch.arange(s, device=device)[None, :]
    return torch.where(idx <= end[:, None] + t - 1, idx, -1)


def query_positions(cache_index, b: int, t: int, device) -> torch.Tensor:
    base = torch.as_tensor(cache_index, device=device).reshape(-1, 1)
    return (base + torch.arange(t, device=device)[None]).expand(b, t)


def kv_lengths(cache_index, b: int, t: int, device) -> torch.Tensor:
    """Each row's key count after writing T tokens at ``cache_index``:
    int32 [B], K15's ``kv_len``."""
    if isinstance(cache_index, int):
        return torch.full((b,), cache_index + t, dtype=torch.int32,
                          device=device)
    return (cache_index + t).to(torch.int32)


class AttnInputs:
    """What every attention layer of one forward derives from its
    positions, computed once a forward (``transformer.forward``), not
    once a layer: the rope tables (by dtype), the cache-write indices,
    K15's ``kv_len`` and the plain path's key positions (by cache
    length).  Each is computed when a layer first asks for it, by the
    ops the per-layer code used, so every result keeps its bits.

    ``cache_index`` is None (no cache), an int, or an int64 ``[B]``
    tensor on the positions' device."""

    def __init__(self, positions: torch.Tensor, cache_index, *,
                 theta: float, head_dim: int):
        self.positions = positions
        self.cache_index = cache_index
        self.theta = theta
        self.head_dim = head_dim
        self._rope: dict[torch.dtype, tuple[torch.Tensor, torch.Tensor]] = {}
        self._kv_pos: dict[int, torch.Tensor] = {}

    def rope(self, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
        """``layers.rope_tables`` at the positions, in ``dtype``."""
        if dtype not in self._rope:
            self._rope[dtype] = rope_tables(self.positions, self.theta,
                                            self.head_dim, dtype)
        return self._rope[dtype]

    @functools.cached_property
    def scatter_index(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(rows [B, 1], cols [B, T]) of a per-row cache write."""
        b, t = self.positions.shape
        dev = self.positions.device
        rows = torch.arange(b, device=dev)[:, None]
        cols = self.cache_index[:, None] + torch.arange(t, device=dev)[None]
        return rows, cols

    @functools.cached_property
    def kv_len(self) -> torch.Tensor:
        """Each row's key count after this forward's write (K15's)."""
        b, t = self.positions.shape
        return kv_lengths(self.cache_index, b, t, self.positions.device)

    def kv_pos(self, s: int) -> torch.Tensor:
        """The plain path's key positions over an ``s``-slot cache."""
        if s not in self._kv_pos:
            b, t = self.positions.shape
            self._kv_pos[s] = _cache_positions(self.cache_index, b, s, t,
                                               self.positions.device)
        return self._kv_pos[s]


# ---------------------------------------------------------------------------
# Masked grouped attention core (positions-based masking)
# ---------------------------------------------------------------------------

def _mask(q_pos, kv_pos, causal: bool, window: int | None) -> torch.Tensor:
    """q_pos: [B, T], kv_pos: [B, S] (< 0 marks invalid slots)."""
    m = (kv_pos >= 0)[:, None, :]
    if causal:
        m = m & (kv_pos[:, None, :] <= q_pos[:, :, None])
    if window is not None:
        m = m & (kv_pos[:, None, :] > q_pos[:, :, None] - window)
    return m                                                 # [B, T, S]


def grouped_attention(q, k, v, q_pos, kv_pos, *, causal: bool,
                      window: int | None, softcap: float | None,
                      scale: float, fp32_softmax: bool = True
                      ) -> torch.Tensor:
    """q: [B, T, H, Dh], k/v: [B, S, KvH, Dh] -> [B, T, H, Dh]."""
    b, t, h, dh = q.shape
    kvh = k.shape[2]
    q5 = q.reshape(b, t, kvh, h // kvh, dh)
    logits = torch.einsum("btkgd,bskd->bkgts", q5, k)
    if fp32_softmax:
        logits = logits.float()
    logits = logits * torch.tensor(scale, dtype=logits.dtype)
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    m = _mask(q_pos, kv_pos, causal, window)
    neg = NEG_INF if fp32_softmax else -3e38
    logits = torch.where(m[:, None, None], logits, neg)
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", p, v)
    return out.reshape(b, t, h, dh)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------

def gqa_forward(params: dict, x: torch.Tensor, inputs: AttnInputs, *,
                cfg: ModelConfig, window: int | None, cache: dict | None,
                backend: str = "torch") -> tuple[torch.Tensor, dict | None]:
    """x [B, T, D] -> (attention output [B, T, D], the cache written in
    place or None).  ``inputs`` holds the forward's positions and cache
    index (None without a cache) and what the layers derive from them."""
    b, t, _ = x.shape
    h, kvh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale = cfg.query_scale if cfg.query_scale is not None else dh ** -0.5

    q = (x @ params["q_proj"]).reshape(b, t, h, dh)
    k = (x @ params["k_proj"]).reshape(b, t, kvh, dh)
    v = (x @ params["v_proj"]).reshape(b, t, kvh, dh)
    q = apply_rope(q, *inputs.rope(q.dtype))
    k = apply_rope(k, *inputs.rope(k.dtype))

    if cache is not None:
        _cache_write(cache["k"], k, inputs)
        _cache_write(cache["v"], v, inputs)
        k, v = cache["k"], cache["v"]

    if backend == "kernels":
        if not cfg.attn_fp32_softmax:
            raise ValueError("attn_fp32_softmax=False (bf16 logits) has no "
                             "kernel: K15 computes fp32 statistics; use "
                             "backend='torch'")
        out = ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=cfg.causal, window=window,
            softcap=cfg.attn_logit_softcap, scale=scale,
            kv_len=None if cache is None else inputs.kv_len).transpose(1, 2)
    else:
        kv_pos = (inputs.positions if cache is None
                  else inputs.kv_pos(k.shape[1]))
        out = grouped_attention(q, k.to(q.dtype), v.to(q.dtype),
                                inputs.positions, kv_pos, causal=cfg.causal,
                                window=window,
                                softcap=cfg.attn_logit_softcap, scale=scale,
                                fp32_softmax=cfg.attn_fp32_softmax)
    return out.reshape(b, t, h * dh) @ params["o_proj"], cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype, device: torch.device,
               lead: tuple[int, ...] = ()) -> dict:
    """One layer's cache (``lead`` stacks a pattern slot's repeats),
    in attention layout [B, S, KvH, Dh]: the kernel reads it in place."""
    if cfg.mla:
        raise NotImplementedError(MLA_TODO)
    shape = lead + (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
