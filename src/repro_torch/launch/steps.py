"""Step functions driven by the LM training and serving loops: the
counterpart of ``repro/launch/steps.py``.

``make_train_step`` is forward + backward + AdamW in mixed precision:
fp32 master weights, the forward and backward in a cast copy
(``cast_tree``, the reference's compute cast: parameters are cast, not
autocast, and TF32 stays off).  ``grad_dtype="fp32"`` differentiates the
fp32 masters through the cast (gradients in fp32); ``"bf16"``
differentiates the cast copy, as the reference does (gradients in the
compute type).  The optimizer updates the masters in place either way.

Training runs on ``backend="torch"``: K15 and K16 have no backward (the
reference's Pallas kernels have no VJP either), so a train step asked
for ``"kernels"`` raises rather than run the plain path under another
name.  Sharding (the reference's ``shd`` and ``grad_shardings``) waits
for ``parallel/`` (ROADMAP queue 1, item 11f); a step given one raises.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch import tree
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (decode_step, forward,
                                            init_model_cache, lm_loss)
from repro_torch.train.optimizer import OptConfig, adamw_update

SHARDING_TODO = ("sharded steps wait for parallel/ (ROADMAP queue 1, item "
                 "11f)")
GRAD_DTYPES = ("fp32", "bf16")


def _refuse_sharding(shd) -> None:
    if shd is not None:
        raise NotImplementedError(SHARDING_TODO)


def cast_tree(params: Any, dtype: torch.dtype) -> Any:
    """Cast the float leaves -- the compute cast.  A leaf already of
    ``dtype`` is returned as it is."""
    return tree.tree_map(
        lambda x: x.to(dtype) if x.is_floating_point() else x, params)


def leaf_grads(loss: torch.Tensor, leaves: list) -> list[torch.Tensor]:
    """The gradient of ``loss`` in each leaf; 0 for a leaf the loss never
    reads (an untied encoder's ``embed``), as ``jax.grad`` gives it."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)]


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, shd=None, *,
                    compute_dtype: torch.dtype = torch.bfloat16,
                    grad_dtype: str = "fp32", grad_shardings=None,
                    backend: str = "torch"):
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``.

    ``params`` are the fp32 masters (a tree of tensors), updated in place
    with ``opt_state``; ``batch`` holds ``inputs``, ``targets`` and an
    optional ``mask`` (on the params' device).  ``metrics``: ``loss``,
    ``ce``, ``aux`` (detached), ``grad_norm`` and ``lr``."""
    _refuse_sharding(shd)
    _refuse_sharding(grad_shardings)
    if backend != "torch":
        raise ValueError(f"make_train_step: backend {backend!r} has no "
                         f"backward (K15 and K16 are forward-only); train "
                         f"on backend='torch'")
    if grad_dtype not in GRAD_DTYPES:
        raise ValueError(f"grad_dtype {grad_dtype!r}; choose from "
                         f"{GRAD_DTYPES}")

    def leaf(p):
        return p.detach().requires_grad_()

    def train_step(params, opt_state, batch):
        with torch.enable_grad():
            if grad_dtype == "bf16":
                cparams = tree.tree_map(leaf, cast_tree(params,
                                                        compute_dtype))
                wrt = cparams
            else:
                wrt = tree.tree_map(leaf, params)
                cparams = cast_tree(wrt, compute_dtype)
            loss, metrics = lm_loss(cparams, batch, cfg, backend=backend)
            grads = leaf_grads(loss, tree.leaves(wrt))
        del cparams, wrt, loss
        params, opt_state, opt_metrics = adamw_update(params, grads,
                                                      opt_state, opt_cfg)
        return params, opt_state, {
            **{k: v.detach() for k, v in metrics.items()}, **opt_metrics}

    return train_step


def make_prefill_step(cfg: ModelConfig, shape_seq: int, shd=None, *,
                      cache_dtype: torch.dtype = torch.bfloat16,
                      backend: str = "torch"):
    """``(params, tokens) -> (last logits [B, V], cache)``; an encoder's
    ``(logits, None)``.  Runs without autograd."""
    _refuse_sharding(shd)

    @torch.no_grad()
    def prefill_step(params, tokens):
        if not cfg.has_decode:
            logits, _, _ = forward(params, tokens, cfg=cfg, backend=backend)
            return logits, None
        cache = init_model_cache(cfg, torch.as_tensor(tokens).shape[0],
                                 shape_seq, cache_dtype,
                                 device=params["embed"].device)
        logits, cache, _ = forward(params, tokens, cfg=cfg, cache=cache,
                                   cache_index=0, backend=backend)
        return logits[:, -1], cache

    return prefill_step


def make_serve_step(cfg: ModelConfig, shd=None, *, backend: str = "torch"):
    """``(params, cache, token [B, 1], index) -> (next token [B, 1],
    logits [B, V], cache)`` -- greedy, the cache written in place."""
    _refuse_sharding(shd)

    @torch.no_grad()
    def serve_step(params, cache, token, index):
        logits, cache = decode_step(params, cache, token, index, cfg,
                                    backend=backend)
        nxt = torch.argmax(logits[:, -1], dim=-1)
        return nxt[:, None], logits[:, -1], cache

    return serve_step
