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
name.

Sharding: given ``shd`` (``parallel.sharding.ShardingCtx`` over a
``DeviceMesh``), each step runs one process a rank on DTensors -- the
parameters placed by ``param_shardings``, the optimizer moments by
``zero1_shardings`` or as the parameters, the activations at the
reference's ``shd.act`` sites.  ``grad_shardings`` (a ``NamedSharding``
tree of the params' structure) places the gradients before the
optimizer, as the reference pins them.  The metrics come back as plain
tensors, whole on every rank.  A step given ``shd`` runs on
``backend="torch"`` only (K15/K16 take no DTensor) and raises otherwise;
``ShardingCtx(mesh=None)`` is the plain step.
"""

from __future__ import annotations

import contextlib
from typing import Any

import torch

from repro_torch import tree
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (decode_step, forward,
                                            init_model_cache, lm_loss)
from repro_torch.parallel.sharding import full, like, place
from repro_torch.train.optimizer import OptConfig, adamw_update

GRAD_DTYPES = ("fp32", "bf16")


def _check_sharded_backend(shd, backend: str, what: str) -> None:
    if shd is not None and backend != "torch":
        raise ValueError(f"{what}: a sharded step runs on backend='torch' "
                         f"(K15 and K16 take no DTensor), not {backend!r}")


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
    _check_sharded_backend(shd, backend, "make_train_step")
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
        # Under a mesh the plain tensors made in the step (positions,
        # masks, the targets' gather index in the backward) meet DTensors
        # as replicated.
        region = (shd.region() if shd is not None
                  else contextlib.nullcontext())
        with region:
            with torch.enable_grad():
                if grad_dtype == "bf16":
                    cparams = tree.tree_map(leaf, cast_tree(params,
                                                            compute_dtype))
                    wrt = cparams
                else:
                    wrt = tree.tree_map(leaf, params)
                    cparams = cast_tree(wrt, compute_dtype)
                loss, metrics = lm_loss(cparams, batch, cfg, shd,
                                        backend=backend)
                grads = leaf_grads(loss, tree.leaves(wrt))
            del cparams, wrt, loss
            # The gradient reduction point: each gradient in its
            # ``grad_shardings`` placement, by default its parameter's.
            if grad_shardings is not None:
                grads = [place(g, s) for g, s in
                         zip(grads, tree.leaves(grad_shardings), strict=True)]
            else:
                grads = [like(g, p) for g, p in
                         zip(grads, tree.leaves(params), strict=True)]
            params, opt_state, opt_metrics = adamw_update(params, grads,
                                                          opt_state, opt_cfg)
            return params, opt_state, {
                k: full(v.detach()) for k, v in {**metrics,
                                                 **opt_metrics}.items()}

    return train_step


def make_prefill_step(cfg: ModelConfig, shape_seq: int, shd=None, *,
                      cache_dtype: torch.dtype = torch.bfloat16,
                      backend: str = "torch"):
    """``(params, tokens) -> (last logits [B, V], cache)``; an encoder's
    ``(logits, None)``.  Runs without autograd; under ``shd`` the cache is
    placed by ``cache_shardings`` and the logits are DTensors."""
    _check_sharded_backend(shd, backend, "make_prefill_step")

    @torch.no_grad()
    def prefill_step(params, tokens):
        if not cfg.has_decode:
            logits, _, _ = forward(params, tokens, cfg=cfg, shd=shd,
                                   backend=backend)
            return logits, None
        cache = init_model_cache(cfg, torch.as_tensor(tokens).shape[0],
                                 shape_seq, cache_dtype,
                                 device=params["embed"].device, shd=shd)
        logits, cache, _ = forward(params, tokens, cfg=cfg, shd=shd,
                                   cache=cache, cache_index=0,
                                   backend=backend)
        return logits[:, -1], cache

    return prefill_step


def make_serve_step(cfg: ModelConfig, shd=None, *, backend: str = "torch"):
    """``(params, cache, token [B, 1], index) -> (next token [B, 1],
    logits [B, V], cache)`` -- greedy, the cache written in place.  Under
    ``shd`` the logits are gathered whole before the argmax."""
    _check_sharded_backend(shd, backend, "make_serve_step")

    @torch.no_grad()
    def serve_step(params, cache, token, index):
        logits, cache = decode_step(params, cache, token, index, cfg, shd,
                                    backend=backend)
        logits = full(logits[:, -1])
        nxt = torch.argmax(logits, dim=-1)
        return nxt[:, None], logits, cache

    return serve_step
