"""Attention of the LM family: the counterpart of
``repro/models/attention.py`` -- GQA/MQA/MHA (sliding window, softcap,
bidirectional) and MLA (DeepSeek's multi-head latent attention), with KV
caches for decode.

Decode caches (per layer), preallocated by ``init_cache``:

* GQA: ``{"k": [B, S, KvH, Dh], "v": [B, S, KvH, Dh]}`` in attention
  layout;
* MLA: ``{"c_kv": [B, S, R], "k_rope": [B, S, Rr]}``, the compressed
  latent and the shared rope key.

The reference's functional ``_cache_update`` (a ``dynamic_update_slice``)
becomes an indexed write INTO the cache tensors: ``gqa_forward`` and
``mla_forward`` update the cache in place and return the same dict.

``cache_index`` is a scalar (every row aligned) or a per-row vector
``[B]`` (the slot-based serving engine).  ``backend="torch"`` computes
``grouped_attention``, the reference's masked softmax over the whole
cache; ``backend="kernels"`` calls K15 (``ops.flash_attention``) on the
cache in place -- strided views, no transpose and no expanded KV heads --
with each row's key count ``kv_len = cache_index + T``.  What every layer
derives from the positions (rope tables, cache-write indices, ``kv_len``)
is computed once a forward, in ``AttnInputs``.

MLA runs in plain PyTorch on both backends, op for op the reference's
``mla_forward``: the reference computes it in jnp with no Pallas kernel,
so there is no TPU kernel for a port kernel to replace.  Without a cache
it is the explicit form (the whole sequence up-projected to keys and
values); with one it is the absorbed form (``q_nope`` projected into the
latent space by ``W_uk``, attention against the compressed cache, the
context up-projected once by ``W_uv``).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_rope, init_linear, rope_tables,
                                       rs_proj)
from repro_torch.parallel import compat
from repro_torch.parallel.sharding import (P, shard_count, to_placements,
                                           unshard_dim)

NEG_INF = -1e30


def init_attn_params(generator: torch.Generator, cfg: ModelConfig,
                     dtype: torch.dtype, device: torch.device,
                     lead: tuple[int, ...] = ()) -> dict:
    d, dh = cfg.d_model, cfg.head_dim
    if cfg.mla:
        m = cfg.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        return {
            "q_proj": init_linear(generator, d, cfg.num_heads * qk, dtype,
                                  device, lead),
            "kv_down": init_linear(generator, d, m.kv_lora_rank
                                   + m.qk_rope_head_dim, dtype, device,
                                   lead),
            "kv_up": init_linear(generator, m.kv_lora_rank,
                                 cfg.num_heads * (m.qk_nope_head_dim
                                                  + m.v_head_dim),
                                 dtype, device, lead),
            "o_proj": init_linear(generator, cfg.num_heads * m.v_head_dim,
                                  d, dtype, device, lead),
        }
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
    if kvh % shard_count(q, 2):
        # Heads sharded finer than the KV groups: DTensor cannot split
        # them into groups, so gather the heads first.
        q = unshard_dim(q, 2)
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

def _local_attention(shd, q, k, v, q_pos, kv_pos, **kw) -> torch.Tensor:
    """``grouped_attention`` of a sharded forward on each rank's shard:
    attention is independent over the batch rows and the KV groups, so
    each rank attends its rows (over ``data``) and its heads (over
    ``model``, when both head counts divide by it; otherwise every head)
    on local tensors, and the result is the DTensor of those shards.
    The einsums on DTensors would reach the same values through
    DTensor's planning of every contraction."""
    dp, tp = shd.rules.dp, shd.rules.tp
    n = shd.tp_size()
    heads = tp if q.shape[2] % n == 0 and k.shape[2] % n == 0 else None
    rows = dp if q.shape[0] % shd.axis_size(dp) == 0 else None
    spec = P(rows, None, heads, None)
    ql, kl, vl = (shd.constrain(x, spec).to_local() for x in (q, k, v))
    qp, kp = (shd.constrain(x, P(rows, None)).to_local()
              for x in (q_pos, kv_pos))
    out = grouped_attention(ql, kl, vl, qp, kp, **kw)
    return compat.DTensor.from_local(out, shd.mesh,
                                     to_placements(spec, shd.mesh),
                                     run_check=False)


def _heads(y: torch.Tensor, n: int, dh: int, shd) -> torch.Tensor:
    """A projection [B, T, n * dh] as heads [B, T, n, dh].  Under a mesh
    whose model axis does not divide ``n``, DTensor cannot split the
    model-sharded feature dim into heads: gather it first (the ``act``
    rule leaves such heads unsharded anyway)."""
    if shd is not None and shd.active and n % shd.tp_size():
        y = unshard_dim(y, -1)
    return y.reshape(y.shape[0], y.shape[1], n, dh)


def gqa_forward(params: dict, x: torch.Tensor, inputs: AttnInputs, *,
                cfg: ModelConfig, window: int | None, cache: dict | None,
                backend: str = "torch", shd=None
                ) -> tuple[torch.Tensor, dict | None]:
    """x [B, T, D] -> (attention output [B, T, D], the cache written in
    place or None).  ``inputs`` holds the forward's positions and cache
    index (None without a cache) and what the layers derive from them.
    ``shd`` places q/k/v and the output over the heads (the reference's
    sites); with ``cfg.manual_tp`` and no cache the output projection is
    ``layers.rs_proj``."""
    b, t, _ = x.shape
    h, kvh, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale = cfg.query_scale if cfg.query_scale is not None else dh ** -0.5

    q = _heads(x @ params["q_proj"], h, dh, shd)
    k = _heads(x @ params["k_proj"], kvh, dh, shd)
    v = _heads(x @ params["v_proj"], kvh, dh, shd)
    if shd is not None:
        q = shd.act(q, "bthd")
        k = shd.act(k, "btkd")
        v = shd.act(v, "btkd")
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
        core = (functools.partial(_local_attention, shd)
                if shd is not None and shd.active else grouped_attention)
        out = core(q, k.to(q.dtype), v.to(q.dtype), inputs.positions,
                   kv_pos, causal=cfg.causal, window=window,
                   softcap=cfg.attn_logit_softcap, scale=scale,
                   fp32_softmax=cfg.attn_fp32_softmax)
    if shd is not None:
        out = shd.act(out, "bthd")
    out = out.reshape(b, t, h * dh)
    if cfg.manual_tp and cache is None:
        return rs_proj(out, params["o_proj"], shd), cache
    return out @ params["o_proj"], cache


# ---------------------------------------------------------------------------
# MLA block
# ---------------------------------------------------------------------------

def _mla_split_up(params: dict, cfg: ModelConfig
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``kv_up`` as W_uk [R, H, nope] and W_uv [R, H, vd]."""
    m = cfg.mla
    up = params["kv_up"].reshape(m.kv_lora_rank, cfg.num_heads,
                                 m.qk_nope_head_dim + m.v_head_dim)
    return up[..., :m.qk_nope_head_dim], up[..., m.qk_nope_head_dim:]


def _mla_softmax(logits: torch.Tensor, mask: torch.Tensor, scale: float,
                 fp32: bool, dtype: torch.dtype) -> torch.Tensor:
    """The reference's MLA softmax: fp32 logits under ``fp32`` (else the
    model's type, masked at -3e38), scaled, masked, softmaxed, cast to
    ``dtype``."""
    if fp32:
        logits = logits.float()
    logits = logits * torch.tensor(scale, dtype=logits.dtype)
    logits = torch.where(mask[:, None], logits, NEG_INF if fp32 else -3e38)
    return torch.softmax(logits, dim=-1).to(dtype)


def _mla_explicit(q_nope, q_rope, k_nope, k_rope, v, positions, *,
                  causal: bool, scale: float, fp32: bool) -> torch.Tensor:
    """The explicit form's attention: [B, T, H, vd]."""
    logits = (torch.einsum("bthn,bshn->bhts", q_nope, k_nope)
              + torch.einsum("bthr,bsr->bhts", q_rope, k_rope))
    msk = _mask(positions, positions, causal, None)
    p = _mla_softmax(logits, msk, scale, fp32, v.dtype)
    return torch.einsum("bhts,bshv->bthv", p, v)


def _local_mla(shd, attend, q_nope, q_rope, k_nope, k_rope, v, positions
               ) -> torch.Tensor:
    """``attend`` of a sharded forward on each rank's rows (over ``data``)
    and heads (over ``model`` when it divides them), as
    ``_local_attention`` does; the shared rope key has no head dim."""
    dp, tp = shd.rules.dp, shd.rules.tp
    heads = tp if q_nope.shape[2] % shd.tp_size() == 0 else None
    rows = dp if q_nope.shape[0] % shd.axis_size(dp) == 0 else None
    spec = P(rows, None, heads, None)
    qn, qr, kn, vl = (shd.constrain(x, spec).to_local()
                      for x in (q_nope, q_rope, k_nope, v))
    kr_spec = P(rows, None, None)
    # The rope key meets only this rank's heads: its local gradient is
    # this rank's part of the sum over the model axis.
    kr_grad = [compat.Partial() if heads and name == tp else p
               for name, p in zip(shd.mesh.mesh_dim_names,
                                  to_placements(kr_spec, shd.mesh))]
    kr = shd.constrain(k_rope, kr_spec).to_local(grad_placements=kr_grad)
    pos = shd.constrain(positions, P(rows, None)).to_local()
    return compat.DTensor.from_local(attend(qn, qr, kn, kr, vl, pos),
                                     shd.mesh, to_placements(spec, shd.mesh),
                                     run_check=False)


def mla_forward(params: dict, x: torch.Tensor, inputs: AttnInputs, *,
                cfg: ModelConfig, cache: dict | None, shd=None
                ) -> tuple[torch.Tensor, dict | None]:
    """x [B, T, D] -> (attention output [B, T, D], the cache written in
    place or None): the explicit form without a cache, the absorbed form
    with one (module docstring).  ``inputs`` carries the rope tables at
    ``qk_rope_head_dim``."""
    m = cfg.mla
    b, t, _ = x.shape
    h = cfg.num_heads
    nope, rd, vd = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim
    scale = (nope + rd) ** -0.5

    q = (x @ params["q_proj"]).reshape(b, t, h, nope + rd)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    q_rope = apply_rope(q_rope, *inputs.rope(q_rope.dtype))
    down = x @ params["kv_down"]                        # [B, T, R + Rr]
    c_kv, k_rope = down[..., :m.kv_lora_rank], down[..., m.kv_lora_rank:]
    k_rope = apply_rope(k_rope[:, :, None, :],
                        *inputs.rope(k_rope.dtype))[:, :, 0]
    w_uk, w_uv = _mla_split_up(params, cfg)   # [R, H, nope], [R, H, vd]

    if cache is None:
        # Explicit (prefill / train) form: up-project the whole sequence.
        k_nope = torch.einsum("btr,rhn->bthn", c_kv, w_uk)
        v = torch.einsum("btr,rhv->bthv", c_kv, w_uv)
        attend = functools.partial(_mla_explicit, causal=cfg.causal,
                                   scale=scale,
                                   fp32=cfg.attn_fp32_softmax)
        if shd is not None and shd.active:
            out = _local_mla(shd, attend, q_nope, q_rope, k_nope, k_rope, v,
                             inputs.positions)
        else:
            out = attend(q_nope, q_rope, k_nope, k_rope, v,
                         inputs.positions)
    else:
        # Absorbed (decode) form: attend in the compressed latent space.
        _cache_write(cache["c_kv"], c_kv, inputs)
        _cache_write(cache["k_rope"], k_rope, inputs)
        c_all, r_all = cache["c_kv"], cache["k_rope"]
        q_lat = torch.einsum("bthn,rhn->bthr", q_nope, w_uk)   # [B,T,H,R]
        logits = (torch.einsum("bthr,bsr->bhts", q_lat,
                               c_all.to(q_lat.dtype))
                  + torch.einsum("bthr,bsr->bhts", q_rope,
                                 r_all.to(q_rope.dtype)))
        msk = _mask(inputs.positions, inputs.kv_pos(c_all.shape[1]),
                    cfg.causal, None)
        p = _mla_softmax(logits, msk, scale, cfg.attn_fp32_softmax, x.dtype)
        # Heads before T: torch's einsum then flattens (h, t) into the
        # matmul's rows, which a head-sharded DTensor allows; (t, h)
        # torch 2.11's DTensor refuses.
        ctx = torch.einsum("bhts,bsr->bhtr", p,
                           c_all.to(p.dtype)).transpose(1, 2)
        out = torch.einsum("bthr,rhv->bthv", ctx, w_uv)
    return out.reshape(b, t, h * vd) @ params["o_proj"], cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype, device: torch.device,
               lead: tuple[int, ...] = ()) -> dict:
    """One layer's cache (``lead`` stacks a pattern slot's repeats): GQA's
    in attention layout [B, S, KvH, Dh] (the kernel reads it in place),
    MLA's compressed latent and rope key."""
    if cfg.mla:
        m = cfg.mla
        return {"c_kv": torch.zeros(lead + (batch, max_len, m.kv_lora_rank),
                                    dtype=dtype, device=device),
                "k_rope": torch.zeros(lead + (batch, max_len,
                                              m.qk_rope_head_dim),
                                      dtype=dtype, device=device)}
    shape = lead + (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
