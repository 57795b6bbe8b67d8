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
with each row's key count ``kv_len = cache_index + T``.

MLA (DeepSeek's latent attention) waits for its ROADMAP item.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import init_linear, rope

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

def _cache_write(buf: torch.Tensor, val: torch.Tensor, cache_index) -> None:
    """Write ``val`` [B, T, ...] into ``buf`` [B, S, ...] at sequence
    position ``cache_index``: an int (every row), or an int64 ``[B]``
    tensor (one position per row)."""
    t = val.shape[1]
    if isinstance(cache_index, int):
        buf[:, cache_index:cache_index + t] = val
        return
    b = val.shape[0]
    rows = torch.arange(b, device=buf.device)[:, None]
    cols = cache_index[:, None] + torch.arange(t, device=buf.device)[None]
    buf[rows, cols] = val.to(buf.dtype)


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
    logits = torch.where(m[:, None, None], logits,
                         torch.tensor(neg, dtype=logits.dtype))
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskd->btkgd", p, v)
    return out.reshape(b, t, h, dh)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------

def gqa_forward(params: dict, x: torch.Tensor, positions: torch.Tensor, *,
                cfg: ModelConfig, window: int | None, cache: dict | None,
                cache_index, backend: str = "torch"
                ) -> tuple[torch.Tensor, dict | None]:
    """x [B, T, D] -> (attention output [B, T, D], the cache written in
    place or None).  ``cache_index`` is None without a cache, else an int
    or an int64 ``[B]`` tensor on x's device."""
    b, t, _ = x.shape
    h, kvh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale = cfg.query_scale if cfg.query_scale is not None else dh ** -0.5

    q = (x @ params["q_proj"]).reshape(b, t, h, dh)
    k = (x @ params["k_proj"]).reshape(b, t, kvh, dh)
    v = (x @ params["v_proj"]).reshape(b, t, kvh, dh)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    if cache is not None:
        _cache_write(cache["k"], k, cache_index)
        _cache_write(cache["v"], v, cache_index)
        k, v = cache["k"], cache["v"]

    if backend == "kernels":
        if not cfg.attn_fp32_softmax:
            raise ValueError("attn_fp32_softmax=False (bf16 logits) has no "
                             "kernel: K15 computes fp32 statistics; use "
                             "backend='torch'")
        kv_len = (None if cache is None
                  else kv_lengths(cache_index, b, t, x.device))
        out = ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=cfg.causal, window=window,
            softcap=cfg.attn_logit_softcap, scale=scale,
            kv_len=kv_len).transpose(1, 2)
    else:
        kv_pos = (positions if cache is None else _cache_positions(
            cache_index, b, k.shape[1], t, x.device))
        out = grouped_attention(q, k.to(q.dtype), v.to(q.dtype), positions,
                                kv_pos, causal=cfg.causal, window=window,
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
