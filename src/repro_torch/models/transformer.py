"""Block-pattern transformer stack of the LM family: init, forward,
prefill, decode -- the counterpart of ``repro/models/transformer.py``.

The stack is ``prefix + pattern * repeats + suffix`` with the reference's
parameter tree: ``blocks["s{i}"]`` leaves stacked ``[repeats, ...]``,
``prefix`` and ``suffix`` lists, so ``convert.lm_params_from_numpy`` is a
copy.  The reference's ``jax.lax.scan`` over the repeats is a Python loop
over views of the stacked leaves; serving needs no remat.

``backend="kernels"`` runs every attention on K15 and every fp32 RMSNorm
on K16 (``ops.flash_attention`` / ``ops.rmsnorm``); ``backend="torch"`` is
the plain reference path.  Both compute the reference's jnp function.
Caches are written in place (``models/attention.py``).  ``forward``
derives the rope tables, cache-write indices and K15's ``kv_len`` once
for all its layers (``attention.AttnInputs``); it makes no host sync when
its tokens and a per-row ``cache_index`` lie on the device, so the
serving engine captures it into a CUDA graph.

Ported so far: the dense attention blocks (``global``, ``local``,
``bidir``).  MoE, MLA, ``mamba`` and ``shared_attn`` blocks and the audio
frontend raise ``NotImplementedError`` naming their ROADMAP item; the
reference's ``lm_loss`` / ``cross_entropy`` come with LM training.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (BACKENDS, embed_tokens, gated_mlp,
                                       init_linear, lm_head, rmsnorm)

Params = dict[str, Any]

ATTN_KINDS = ("global", "local", "bidir")
_TODO = {
    "moe": "MoE layers are not ported yet (ROADMAP queue 1, item 11b)",
    "mla": attn.MLA_TODO,
    "mamba": "mamba and hybrid blocks are not ported yet (ROADMAP queue 1, "
             "item 11d)",
    "audio": "the audio frontend (hubert) is not ported yet (ROADMAP queue "
             "1, item 11e)",
}


def check_ported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item for any part
    of ``cfg`` the port does not run yet."""
    if cfg.moe is not None:
        raise NotImplementedError(f"{cfg.name}: {_TODO['moe']}")
    if cfg.mla is not None:
        raise NotImplementedError(f"{cfg.name}: {_TODO['mla']}")
    if cfg.frontend is not None:
        raise NotImplementedError(f"{cfg.name}: {_TODO['audio']}")
    other = set(cfg.layer_kinds()) - set(ATTN_KINDS)
    if other:
        raise NotImplementedError(
            f"{cfg.name}: blocks {sorted(other)}: {_TODO['mamba']}")


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from "
                         f"{BACKENDS}")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_attn_block(generator, cfg: ModelConfig, dtype, device,
                     lead: tuple[int, ...] = ()) -> Params:
    d = cfg.d_model

    def zeros():
        return torch.zeros(lead + (d,), dtype=dtype, device=device)

    p: Params = {"input_norm": zeros(), "pre_mlp_norm": zeros()}
    p.update(attn.init_attn_params(generator, cfg, dtype, device, lead))
    p["gate_proj"] = init_linear(generator, d, cfg.d_ff, dtype, device, lead)
    p["up_proj"] = init_linear(generator, d, cfg.d_ff, dtype, device, lead)
    p["down_proj"] = init_linear(generator, cfg.d_ff, d, dtype, device, lead)
    if cfg.use_post_norms:
        p["post_attn_norm"] = zeros()
        p["post_mlp_norm"] = zeros()
    return p


def init_model(generator: torch.Generator, cfg: ModelConfig,
               dtype: torch.dtype = torch.float32, *,
               device: str | torch.device = "cuda") -> Params:
    """Random parameters with the reference's tree, shapes and init laws,
    drawn on ``device`` from ``generator`` (a generator of that device):
    nothing is made on the host.  The values differ from the reference's
    (another generator); parity tests copy the reference's instead
    (``repro_torch.convert.lm_params_from_numpy``)."""
    dev = resolve_device(device)
    cfg.validate()
    check_ported(cfg)
    if generator.device.type != dev.type:
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
    params["prefix"] = [_init_attn_block(generator, cfg, dtype, dev)
                        for _ in cfg.prefix]
    params["suffix"] = [_init_attn_block(generator, cfg, dtype, dev)
                        for _ in cfg.suffix]
    params["blocks"] = {
        f"s{i}": (_init_attn_block(generator, cfg, dtype, dev,
                                   (cfg.repeats,)) if cfg.repeats else {})
        for i in range(len(cfg.pattern))}
    return params


def init_model_cache(cfg: ModelConfig, batch: int, max_len: int,
                     dtype: torch.dtype = torch.bfloat16, *,
                     device: str | torch.device = "cuda") -> dict:
    """Zeroed KV caches in the reference's tree: ``prefix`` / ``suffix``
    lists and ``blocks["s{i}"]`` leaves stacked ``[repeats, ...]``."""
    dev = resolve_device(device)
    check_ported(cfg)
    return {
        "prefix": [attn.init_cache(cfg, batch, max_len, dtype, dev)
                   for _ in cfg.prefix],
        "suffix": [attn.init_cache(cfg, batch, max_len, dtype, dev)
                   for _ in cfg.suffix],
        "blocks": {f"s{i}": attn.init_cache(cfg, batch, max_len, dtype, dev,
                                            (cfg.repeats,))
                   for i in range(len(cfg.pattern))},
    }


def cache_slot(cache: dict, slot: int) -> dict:
    """Views of one batch row of ``cache`` (batch 1): a forward on them
    writes straight into that row of the batch cache."""
    def row(c, ax):
        return {k: v.narrow(ax, slot, 1) for k, v in c.items()}
    return {"prefix": [row(c, 0) for c in cache["prefix"]],
            "suffix": [row(c, 0) for c in cache["suffix"]],
            "blocks": {k: row(c, 1) for k, c in cache["blocks"].items()}}


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------

def _apply_block(p: Params, kind: str, x, inputs: attn.AttnInputs, *,
                 cfg: ModelConfig, cache, backend: str) -> torch.Tensor:
    """One attention block: norms, attention, MLP, residuals.  The cache,
    if any, is written in place."""
    def norm(y, w):
        return rmsnorm(y, w, cfg.norm_eps, cfg.norm_fp32, backend)

    window = cfg.sliding_window if kind == "local" else None
    h = norm(x, p["input_norm"])
    a_out, _ = attn.gqa_forward(p, h, inputs, cfg=cfg, window=window,
                                cache=cache, backend=backend)
    if cfg.use_post_norms:
        a_out = norm(a_out, p["post_attn_norm"])
    x = x + a_out
    h = norm(x, p["pre_mlp_norm"])
    m_out = gated_mlp(h, p["gate_proj"], p["up_proj"], p["down_proj"],
                      cfg.mlp_act)
    if cfg.use_post_norms:
        m_out = norm(m_out, p["post_mlp_norm"])
    return x + m_out


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

def forward(params: Params, inputs, *, cfg: ModelConfig,
            cache: dict | None = None, cache_index=None,
            backend: str = "torch", last_only: bool = False
            ) -> tuple[torch.Tensor, dict | None, torch.Tensor]:
    """inputs: int tokens [B, T] (a tensor or an array).

    Returns (logits [B, T, V], the cache -- written in place -- or None,
    aux loss).  ``last_only`` computes the final norm and the LM head at
    the last position only (logits [B, 1, V]): all a sampler reads."""
    _check_backend(backend)
    check_ported(cfg)
    dev = params["embed"].device
    tokens = torch.as_tensor(inputs, device=dev).long()
    x = embed_tokens(params["embed"], tokens, cfg.scale_embeddings,
                     cfg.d_model)
    b, t = x.shape[:2]
    ci = _cache_index(cache_index, b, dev)
    if ci is None:
        positions = torch.arange(t, device=dev)[None].expand(b, t)
    else:
        positions = attn.query_positions(ci, b, t, dev)
    if cache is not None and ci is None:
        raise ValueError("forward: a cache needs a cache_index")
    # The rope tables, cache-write indices and kv_len, once for every layer.
    inputs = attn.AttnInputs(positions, ci, theta=cfg.rope_theta,
                             head_dim=cfg.head_dim)
    kw = dict(cfg=cfg, backend=backend)

    for i, kind in enumerate(cfg.prefix):
        c = cache["prefix"][i] if cache is not None else None
        x = _apply_block(params["prefix"][i], kind, x, inputs, cache=c,
                         **kw)
    for r in range(cfg.repeats):
        for i, kind in enumerate(cfg.pattern):
            slot = params["blocks"][f"s{i}"]
            c = (None if cache is None else
                 {k: v[r] for k, v in cache["blocks"][f"s{i}"].items()})
            x = _apply_block({k: v[r] for k, v in slot.items()}, kind, x,
                             inputs, cache=c, **kw)
    for i, kind in enumerate(cfg.suffix):
        c = cache["suffix"][i] if cache is not None else None
        x = _apply_block(params["suffix"][i], kind, x, inputs, cache=c,
                         **kw)

    if last_only:
        x = x[:, -1:]
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps, cfg.norm_fp32,
                backend)
    logits = lm_head(x, params["embed"] if cfg.tie_embeddings
                     else params["unembed"], cfg.tie_embeddings,
                     cfg.final_logit_softcap, cfg.logits_fp32,
                     valid_vocab=cfg.vocab_size)
    aux = torch.zeros((), dtype=torch.float32, device=dev)
    return logits, cache, aux


def prefill(params: Params, tokens, cfg: ModelConfig, max_len: int, *,
            cache_dtype: torch.dtype = torch.bfloat16,
            backend: str = "torch") -> tuple[torch.Tensor, dict]:
    """Run the prompt through the model: (logits, a fresh cache)."""
    b = torch.as_tensor(tokens).shape[0]
    cache = init_model_cache(cfg, b, max_len, cache_dtype,
                             device=params["embed"].device)
    logits, cache, _ = forward(params, tokens, cfg=cfg, cache=cache,
                               cache_index=0, backend=backend)
    return logits, cache


def decode_step(params: Params, cache: dict, token, index,
                cfg: ModelConfig, *, backend: str = "torch"
                ) -> tuple[torch.Tensor, dict]:
    """One autoregressive step.  token: [B, 1] -> (logits [B, 1, V],
    the cache, written in place)."""
    logits, cache, _ = forward(params, token, cfg=cfg, cache=cache,
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
