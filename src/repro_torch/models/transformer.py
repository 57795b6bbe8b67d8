"""Block-pattern transformer stack of the LM family: init, forward,
prefill, decode and the training loss -- the counterpart of
``repro/models/transformer.py``.

The stack is ``prefix + pattern * repeats + suffix`` with the reference's
parameter tree: ``blocks["s{i}"]`` leaves stacked ``[repeats, ...]``,
``prefix`` and ``suffix`` lists, so ``convert.lm_params_from_numpy`` is a
copy.  The reference's ``jax.lax.scan`` over the repeats is a Python loop
over views of the stacked leaves.  ``cfg.remat`` applies to each repeat's
body when autograd records and no cache is written: ``"full"`` keeps only
the body's input (``torch.utils.checkpoint``), ``"dots"`` also the
outputs of its 2-D matmuls (the counterpart of
``dots_with_no_batch_dims_saveable``), ``"none"`` everything.  Remat
changes memory, never values.

The aux loss (MoE's load balancing) is summed as the reference sums it:
every prefix and suffix block's, but of a repeat only its LAST pattern
block's (the scan carries ``aux_sum + aux`` after the pattern's loop).

``backend="kernels"`` runs every attention on K15 and every fp32 RMSNorm
on K16 (``ops.flash_attention`` / ``ops.rmsnorm``); ``backend="torch"`` is
the plain reference path.  Both compute the reference's jnp function.
Caches are written in place (``models/attention.py``).  ``forward``
derives the rope tables, cache-write indices and K15's ``kv_len`` once
for all its layers (``attention.AttnInputs``); it makes no host sync when
its tokens and a per-row ``cache_index`` lie on the device, so the
serving engine captures it into a CUDA graph.

Every block kind of the reference runs: attention (``global``,
``local``, ``bidir``; GQA or MLA, ``models/attention.py``) with a dense
or an MoE MLP (``models/moe.py``), ``mamba`` (``models/mamba.py``: the
norm before the block, the residual after) and ``shared_attn`` (Zamba-2:
its pattern slots hold ``{}``, the weights live once in
``params["shared"]`` -- a dense attention-and-MLP block every use reads,
so its gradient is the sum over the uses -- while each use keeps its own
cache slice).  The audio frontend (``frontend="audio_frames"``, hubert)
projects float frames ``[B, T, F]`` by ``params["frontend_proj"]``; the
frames are cast to that weight's type first.  The reference multiplies
fp32 frames by bf16 weights and JAX promotes the whole stack to fp32
under bf16 compute; the port keeps the compute type (the same function
at fp32, a designed deviation under mixed precision).
"""

from __future__ import annotations

import functools
from typing import Any

import torch
from torch.utils import checkpoint as remat

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (BACKENDS, ag_seq, embed_tokens,
                                       gated_mlp, init_linear, lm_head,
                                       rmsnorm)
from repro_torch.parallel.sharding import (cache_shardings, place_tree,
                                           unshard_dim)

Params = dict[str, Any]

REMATS = ("full", "dots", "none")


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from "
                         f"{BACKENDS}")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _uses_moe(cfg: ModelConfig, in_prefix: bool) -> bool:
    """Whether an attention block's MLP is MoE: prefix blocks are dense
    unless ``moe_in_prefix``."""
    return cfg.moe is not None and (cfg.moe_in_prefix or not in_prefix)


def _init_attn_block(generator, cfg: ModelConfig, dtype, device,
                     lead: tuple[int, ...] = (),
                     use_moe: bool = False) -> Params:
    d = cfg.d_model

    def zeros():
        return torch.zeros(lead + (d,), dtype=dtype, device=device)

    p: Params = {"input_norm": zeros(), "pre_mlp_norm": zeros()}
    p.update(attn.init_attn_params(generator, cfg, dtype, device, lead))
    if use_moe:
        p.update(moe_mod.init_moe_params(generator, cfg, dtype, device, lead))
    else:
        p["gate_proj"] = init_linear(generator, d, cfg.d_ff, dtype, device,
                                     lead)
        p["up_proj"] = init_linear(generator, d, cfg.d_ff, dtype, device,
                                   lead)
        p["down_proj"] = init_linear(generator, cfg.d_ff, d, dtype, device,
                                     lead)
    if cfg.use_post_norms:
        p["post_attn_norm"] = zeros()
        p["post_mlp_norm"] = zeros()
    return p


def _init_block(generator, kind: str, cfg: ModelConfig, dtype, device,
                lead: tuple[int, ...] = (), in_prefix: bool = False
                ) -> Params:
    if kind == "mamba":
        p = mb.init_mamba_block(generator, cfg, dtype, device, lead)
        p["input_norm"] = torch.zeros(lead + (cfg.d_model,), dtype=dtype,
                                      device=device)
        return p
    if kind == "shared_attn":
        return {}                      # weights live in params["shared"]
    return _init_attn_block(generator, cfg, dtype, device, lead,
                            _uses_moe(cfg, in_prefix))


def init_model(generator: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype = torch.float32, *,
               device: str | torch.device = "cuda") -> Params:
    """Random parameters with the reference's tree, shapes and init laws,
    drawn on ``device`` from ``generator`` (a generator of that device;
    on ``"meta"``, shapes alone, any generator): nothing is made on the
    host.  The values differ from the reference's
    (another generator); parity tests copy the reference's instead
    (``repro_torch.convert.lm_params_from_numpy``)."""
    dev = resolve_device(device)
    cfg.validate()
    if dev.type != "meta" and generator.device.type != dev.type:
        raise ValueError(f"init_model: the generator lies on "
                         f"{generator.device}, the parameters go to {dev}")
    d = cfg.d_model
    embed = torch.randn((cfg.padded_vocab_size, d), generator=generator,
                        dtype=dtype, device=dev).mul_(1.0 / d ** 0.5)
    params: Params = {"embed": embed,
                      "final_norm": torch.zeros(d, dtype=dtype, device=dev)}
    if not cfg.tie_embeddings:
        params["unembed"] = init_linear(generator, d, cfg.padded_vocab_size,
                                        dtype, dev)
    if cfg.frontend == "audio_frames":
        params["frontend_proj"] = init_linear(generator, cfg.frontend_dim,
                                              d, dtype, dev)
    params["prefix"] = [_init_block(generator, kind, cfg, dtype, dev,
                                    in_prefix=True) for kind in cfg.prefix]
    params["suffix"] = [_init_block(generator, kind, cfg, dtype, dev)
                        for kind in cfg.suffix]
    if "shared_attn" in cfg.layer_kinds():
        params["shared"] = _init_attn_block(generator, cfg, dtype, dev)
    params["blocks"] = {
        f"s{i}": (_init_block(generator, kind, cfg, dtype, dev,
                              (cfg.repeats,)) if cfg.repeats else {})
        for i, kind in enumerate(cfg.pattern)}
    return params


def _block_cache(kind: str, cfg: ModelConfig, batch: int, max_len: int,
                 dtype, device, lead: tuple[int, ...] = ()) -> dict | None:
    """One block's cache: a Mamba block's state (always fp32, as the
    reference's), an attention block's K/V (``bidir`` has none)."""
    if kind == "mamba":
        return mb.init_mamba_cache(cfg, batch, torch.float32, device, lead)
    if kind in ("global", "local", "shared_attn"):
        return attn.init_cache(cfg, batch, max_len, dtype, device, lead)
    return None


def init_model_cache(cfg: ModelConfig, batch: int, max_len: int,
                     dtype: torch.dtype = torch.bfloat16, *,
                     device: str | torch.device = "cuda", shd=None) -> dict:
    """Zeroed caches in the reference's tree: ``prefix`` / ``suffix``
    lists and ``blocks["s{i}"]`` leaves stacked ``[repeats, ...]``; None
    for a block that keeps no cache.  Under ``shd`` each leaf is a DTensor
    placed by ``parallel.sharding.cache_shardings``."""
    dev = resolve_device(device)
    cache = _zero_cache(cfg, batch, max_len, dtype, dev)
    if shd is None or not shd.active:
        return cache
    return place_tree(cache, cache_shardings(cache, shd.rules, shd.mesh))


def _zero_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                dev: torch.device) -> dict:
    return {
        "prefix": [_block_cache(k, cfg, batch, max_len, dtype, dev)
                   for k in cfg.prefix],
        "suffix": [_block_cache(k, cfg, batch, max_len, dtype, dev)
                   for k in cfg.suffix],
        "blocks": {f"s{i}": _block_cache(k, cfg, batch, max_len, dtype, dev,
                                         (cfg.repeats,))
                   for i, k in enumerate(cfg.pattern)},
    }


def cache_slot(cache: dict, slot: int) -> dict:
    """Views of one batch row of ``cache`` (batch 1): a forward on them
    writes straight into that row of the batch cache."""
    def row(c, ax):
        return None if c is None else {k: v.narrow(ax, slot, 1)
                                       for k, v in c.items()}
    return {"prefix": [row(c, 0) for c in cache["prefix"]],
            "suffix": [row(c, 0) for c in cache["suffix"]],
            "blocks": {k: row(c, 1) for k, c in cache["blocks"].items()}}


def reset_states(cfg: ModelConfig, cache: dict) -> None:
    """Zero the recurrent state of every Mamba block of ``cache`` (or of
    ``cache_slot``'s views of one row) in place: a sequence starts from
    no conv tail and no SSD state.  Attention caches are left as they
    are: a forward weighs no key past its row's length."""
    for kinds, caches in ((cfg.prefix, cache["prefix"]),
                          (cfg.suffix, cache["suffix"]),
                          (cfg.pattern, [cache["blocks"][f"s{i}"] for i in
                                         range(len(cfg.pattern))])):
        for kind, c in zip(kinds, caches):
            if kind == "mamba":
                for v in c.values():
                    v.zero_()


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------

def _apply_block(p: Params, kind: str, x, inputs: attn.AttnInputs, *,
                 cfg: ModelConfig, cache, backend: str,
                 shared: Params | None, in_prefix: bool = False, shd=None
                 ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One block: a Mamba block (norm, block, residual), or an attention
    block (norms, GQA or MLA attention, MLP dense or MoE, residuals);
    ``shared_attn`` reads ``shared``.  The cache, if any, is written in
    place.  Returns the block's output and its aux loss (None: 0).
    ``shd`` pins the residual stream and the TP reductions at the
    reference's sites; with ``cfg.manual_tp`` (and no cache) the SP -> TP
    transitions are ``layers.ag_seq`` / ``rs_proj``."""
    def norm(y, w):
        return rmsnorm(y, w, cfg.norm_eps, cfg.norm_fp32, backend)

    def pin(y, kind="btd"):
        return y if shd is None else shd.act(y, kind)

    def tp_in(y):                   # SP -> TP
        return y if shd is None else shd.seq_whole(y)

    if kind == "mamba":
        out, _ = mb.mamba_forward(p, tp_in(norm(x, p["input_norm"])),
                                  cfg=cfg, cache=cache, backend=backend,
                                  shd=shd)
        # The out_proj TP reduction, here, as attention's: left to the
        # sum, torch 2.11's DTensor sends back a sequence-sharded
        # gradient that out_proj's backward cannot flatten.
        return pin(x + pin(out)), None
    blk = shared if kind == "shared_attn" else p
    manual = cfg.manual_tp and cache is None and shd is not None
    h = norm(x, blk["input_norm"])
    # SP -> TP: the explicit all-gather under manual_tp, else DTensor's.
    h = ag_seq(h, shd) if manual else tp_in(h)
    if cfg.mla:
        a_out, _ = attn.mla_forward(blk, h, inputs, cfg=cfg, cache=cache,
                                    shd=shd)
    else:
        window = cfg.sliding_window if kind == "local" else None
        a_out, _ = attn.gqa_forward(blk, h, inputs, cfg=cfg, window=window,
                                    cache=cache, backend=backend, shd=shd)
    a_out = pin(a_out)              # the o_proj TP reduction, here
    if cfg.use_post_norms:
        a_out = norm(a_out, blk["post_attn_norm"])
    x = pin(x + a_out)
    h = norm(x, blk["pre_mlp_norm"])
    aux = None
    use_moe = kind != "shared_attn" and _uses_moe(cfg, in_prefix)
    h = ag_seq(h, shd) if manual and not use_moe else tp_in(h)
    if use_moe:
        m_out, aux = moe_mod.moe_forward(blk, h, cfg=cfg, shd=shd)
    else:
        m_out = gated_mlp(h, blk["gate_proj"], blk["up_proj"],
                          blk["down_proj"], cfg.mlp_act, shd=shd,
                          manual_tp=manual)
    m_out = pin(m_out)              # the down_proj TP reduction
    if cfg.use_post_norms:
        m_out = norm(m_out, blk["post_mlp_norm"])
    return pin(x + m_out), aux


def _cache_index(cache_index, b: int, device):
    """None, an int (every row aligned), or an int64 ``[B]`` tensor on
    ``device`` (one position per row)."""
    if cache_index is None or isinstance(cache_index, int):
        return cache_index
    ci = torch.as_tensor(cache_index)
    if ci.dim() == 0:
        return int(ci)
    if ci.shape != (b,):
        raise ValueError(f"cache_index: a scalar or [{b}], got "
                         f"{tuple(ci.shape)}")
    return ci.to(device=device, dtype=torch.long)


# ---------------------------------------------------------------------------
# Full forward
# ---------------------------------------------------------------------------

def forward(params: Params, inputs, *, cfg: ModelConfig, shd=None,
            cache: dict | None = None, cache_index=None,
            backend: str = "torch", last_only: bool = False
            ) -> tuple[torch.Tensor, dict | None, torch.Tensor]:
    """inputs: int tokens [B, T], or frames [B, T, F] for the audio
    frontend (a tensor or an array).

    Returns (logits [B, T, V], the cache -- written in place -- or None,
    aux loss).  ``last_only`` computes the final norm and the LM head at
    the last position only (logits [B, 1, V]): all a sampler reads.

    ``shd`` (a ``parallel.sharding.ShardingCtx`` over a mesh) runs the
    forward sharded: the parameters (and a cache) are DTensors placed by
    ``param_shardings`` (``cache_shardings``), the activations are
    redistributed at the reference's ``shd.act`` sites and follow
    DTensor's propagation between them; the result is a DTensor."""
    _check_backend(backend)
    if shd is None or not shd.active:
        return _forward(params, inputs, cfg=cfg, shd=None, cache=cache,
                        cache_index=cache_index, backend=backend,
                        last_only=last_only)
    if backend != "torch":
        raise ValueError("a sharded forward runs on backend='torch': K15 "
                         "and K16 take no DTensor")
    with shd.region():
        return _forward(params, inputs, cfg=cfg, shd=shd, cache=cache,
                        cache_index=cache_index, backend=backend,
                        last_only=last_only)


def _forward(params: Params, inputs, *, cfg: ModelConfig, shd, cache,
             cache_index, backend: str, last_only: bool):
    dev = params["embed"].device
    if cfg.frontend == "audio_frames":
        w = params["frontend_proj"]
        x = torch.as_tensor(inputs, device=dev).to(w.dtype) @ w
        if cfg.scale_embeddings:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    else:
        tokens = torch.as_tensor(inputs, device=dev).long()
        x = embed_tokens(params["embed"], tokens, cfg.scale_embeddings,
                         cfg.d_model)
    if shd is not None:
        x = shd.act(x, "btd")
    b, t = x.shape[:2]
    ci = _cache_index(cache_index, b, dev)
    if ci is None:
        positions = torch.arange(t, device=dev)[None].expand(b, t)
    else:
        positions = attn.query_positions(ci, b, t, dev)
    if cache is not None and ci is None:
        raise ValueError("forward: a cache needs a cache_index")
    # The rope tables, cache-write indices and kv_len, once for every layer.
    # (MLA rotates only its qk_rope_head_dim features.)
    inputs = attn.AttnInputs(positions, ci, theta=cfg.rope_theta,
                             head_dim=(cfg.mla.qk_rope_head_dim if cfg.mla
                                       else cfg.head_dim))
    kw = dict(cfg=cfg, backend=backend, shared=params.get("shared"),
              shd=shd)
    aux_total = torch.zeros((), dtype=torch.float32, device=dev)

    for i, kind in enumerate(cfg.prefix):
        c = cache["prefix"][i] if cache is not None else None
        x, aux = _apply_block(params["prefix"][i], kind, x, inputs, cache=c,
                              in_prefix=True, **kw)
        if aux is not None:
            aux_total = aux_total + aux

    def repeat(x, r: int):
        """Repeat ``r`` of the pattern: its output and its last block's
        aux (the reference's scan body)."""
        aux = None
        for i, kind in enumerate(cfg.pattern):
            slot = params["blocks"][f"s{i}"]
            sc = None if cache is None else cache["blocks"][f"s{i}"]
            c = None if sc is None else {k: v[r] for k, v in sc.items()}
            x, aux = _apply_block({k: v[r] for k, v in slot.items()}, kind,
                                  x, inputs, cache=c, **kw)
        return x, aux

    run = _remat(repeat, cfg.remat) if (
        cache is None and torch.is_grad_enabled()) else repeat
    for r in range(cfg.repeats):
        x, aux = run(x, r)
        if aux is not None:
            aux_total = aux_total + aux
    for i, kind in enumerate(cfg.suffix):
        c = cache["suffix"][i] if cache is not None else None
        x, aux = _apply_block(params["suffix"][i], kind, x, inputs, cache=c,
                              **kw)
        if aux is not None:
            aux_total = aux_total + aux

    if last_only:
        x = x[:, -1:]
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps, cfg.norm_fp32,
                backend)
    if shd is not None:
        x = shd.seq_whole(x)
    logits = lm_head(x, params["embed"] if cfg.tie_embeddings
                     else params["unembed"], cfg.tie_embeddings,
                     cfg.final_logit_softcap, cfg.logits_fp32,
                     valid_vocab=cfg.vocab_size)
    if shd is not None:
        logits = shd.act(logits, "logits")
    return logits, cache, aux_total


def _save_matmuls(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the 2-D matmuls' outputs (the projections;
    batched einsums are recomputed), recompute the rest."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return remat.CheckpointPolicy.MUST_SAVE
    return remat.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, mode: str):
    """``fn`` under ``cfg.remat``'s policy (module docstring)."""
    if mode not in REMATS:
        raise ValueError(f"unknown remat {mode!r}; choose from {REMATS}")
    if mode == "none":
        return fn
    kw = {} if mode == "full" else {"context_fn": functools.partial(
        remat.create_selective_checkpoint_contexts, _save_matmuls)}
    return functools.partial(remat.checkpoint, fn, use_reentrant=False, **kw)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, targets, mask=None) -> torch.Tensor:
    """Mean token NLL, computed as logsumexp minus the target logit (no
    full log-softmax), in fp32; with ``mask`` the masked mean over
    ``max(sum(mask), 1)`` tokens."""
    targets = torch.as_tensor(targets, device=logits.device).long()
    # Sharded logits: DTensor's reductions over a sharded vocab (the
    # gather's masked partial, logsumexp's strategy) are not in every
    # release, so the vocab is gathered whole first.
    logits = unshard_dim(logits, -1)
    lse = torch.logsumexp(logits.float(), dim=-1)
    tgt = torch.gather(logits, -1, targets[..., None])[..., 0].float()
    nll = lse - tgt
    if mask is not None:
        mask = torch.as_tensor(mask, device=logits.device)
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def lm_loss(params: Params, batch: dict, cfg: ModelConfig, shd=None, *,
            backend: str = "torch") -> tuple[torch.Tensor, dict]:
    """``(ce + aux, {"loss", "ce", "aux"})`` of ``batch`` (``inputs``,
    ``targets`` and an optional ``mask``); sharded under ``shd``
    (``forward``), the loss then a replicated DTensor."""
    logits, _, aux = forward(params, batch["inputs"], cfg=cfg, shd=shd,
                             backend=backend)
    if shd is not None and shd.active:
        with shd.region():
            ce = cross_entropy(logits, batch["targets"], batch.get("mask"))
            loss = ce + aux
        return loss, {"loss": loss, "ce": ce, "aux": aux}
    ce = cross_entropy(logits, batch["targets"], batch.get("mask"))
    loss = ce + aux
    return loss, {"loss": loss, "ce": ce, "aux": aux}


def prefill(params: Params, tokens, cfg: ModelConfig, max_len: int,
            shd=None, *, cache_dtype: torch.dtype = torch.bfloat16,
            backend: str = "torch") -> tuple[torch.Tensor, dict]:
    """Run the prompt through the model: (logits, a fresh cache; Mamba
    states in fp32 whatever ``cache_dtype``).  Under ``shd`` the cache is
    placed by ``parallel.sharding.cache_shardings``."""
    b = torch.as_tensor(tokens).shape[0]
    cache = init_model_cache(cfg, b, max_len, cache_dtype,
                             device=params["embed"].device, shd=shd)
    logits, cache, _ = forward(params, tokens, cfg=cfg, shd=shd, cache=cache,
                               cache_index=0, backend=backend)
    return logits, cache


def decode_step(params: Params, cache: dict, token, index,
                cfg: ModelConfig, shd=None, *, backend: str = "torch"
                ) -> tuple[torch.Tensor, dict]:
    """One autoregressive step.  token: [B, 1] -> (logits [B, 1, V],
    the cache, written in place)."""
    logits, cache, _ = forward(params, token, cfg=cfg, shd=shd, cache=cache,
                               cache_index=index, backend=backend)
    return logits, cache


def greedy_generate(params: Params, prompt, steps: int, cfg: ModelConfig,
                    max_len: int | None = None, *,
                    backend: str = "torch") -> torch.Tensor:
    """Reference sampler for tests and examples (greedy): [B, steps]."""
    prompt = torch.as_tensor(prompt)
    b, t = prompt.shape
    max_len = max_len or (t + steps)
    logits, cache = prefill(params, prompt, cfg, max_len, backend=backend)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    out = [tok]
    for i in range(steps - 1):
        logits, cache = decode_step(params, cache, tok, t + i, cfg,
                                    backend=backend)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        out.append(tok)
    return torch.cat(out, dim=1)
