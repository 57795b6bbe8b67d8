"""The hybrid (Zamba-2: Mamba2 blocks and one weight-shared attention
block) through the port against the reference, on the CPU: the
zamba2-1.2b smoke model's logits on both backends, prefill and decode,
``ServeEngine`` tokens and finish order against the reference engine,
the shared block's one set of weights and its gradient (the sum over its
uses) against ``jax.grad``, and the remat modes over Mamba and shared
bodies.

Parameters come from the reference's ``init_model`` through
``convert.lm_params_from_numpy``; tokens are seeded numpy arrays fed to
both sides.  Logits are held at rtol/atol 2e-5 (the reference's kernel
tolerance; measured <= 4e-6 with fp32 caches), gradients at 1e-5 of each
leaf's largest value, engine tokens exactly, remat bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import init_model as ref_init
from repro.models import transformer as R
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Request, ServeEngine

ARCH = "zamba2-1.2b"
TOL = dict(rtol=2e-5, atol=2e-5)
GRAD = 1e-5


@functools.lru_cache(maxsize=None)
def _model():
    """(reference params, the port's copy on the CPU, port config)."""
    rp = ref_init(jax.random.PRNGKey(0), ref_smoke(ARCH))
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, rp), "cpu")
    return rp, tp, registry.get_smoke_config(ARCH)


def _tokens(cfg, b, t, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, t)).astype(np.int32)


def test_zamba2_tree_holds_one_shared_block():
    """The pattern's ``shared_attn`` slot holds ``{}``; the attention and
    MLP weights live once in ``params["shared"]`` (unstacked), as the
    reference's; each use keeps its own cache slice."""
    rp, tp, cfg = _model()
    slot = cfg.pattern.index("shared_attn")
    assert tp["blocks"][f"s{slot}"] == {} == rp["blocks"][f"s{slot}"]
    assert tp["shared"]["q_proj"].shape == (cfg.d_model,
                                            cfg.num_heads * cfg.head_dim)
    own = T.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), rp)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), own) == shapes
    cache = T.init_model_cache(cfg, 2, 16, device="cpu")
    assert cache["blocks"][f"s{slot}"]["k"].shape[0] == cfg.repeats
    assert cache["suffix"][0]["ssd"].dtype == torch.float32


@pytest.mark.parametrize("backend", ["torch", "kernels"])
def test_zamba2_smoke_forward_matches_reference(backend):
    rp, tp, cfg = _model()
    toks = _tokens(cfg, 2, 13)
    want, _, _ = R.forward(rp, jnp.asarray(toks), cfg=ref_smoke(ARCH))
    got, cache, aux = T.forward(tp, toks, cfg=cfg, backend=backend)
    assert cache is None and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("backend", ["torch", "kernels"])
def test_zamba2_prefill_and_decode_match_reference(backend):
    """Prefill into fp32 caches (the engine's), decode at a scalar and at
    per-row indices: the shared block's K/V of each use and the Mamba
    states equal the reference's."""
    rp, tp, cfg = _model()
    rcfg = ref_smoke(ARCH)
    toks = _tokens(cfg, 2, 11, seed=1)
    want, rcache = R.prefill(rp, jnp.asarray(toks), rcfg, max_len=24,
                             cache_dtype=jnp.float32)
    got, cache = T.prefill(tp, toks, cfg, 24, cache_dtype=torch.float32,
                           backend=backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    tok = np.array([[3], [7]], np.int32)
    for idx in (11, np.array([12, 5], np.int32)):
        want, rcache = R.decode_step(rp, rcache, jnp.asarray(tok),
                                     jnp.asarray(idx), rcfg)
        got, cache = T.decode_step(tp, cache, tok, idx, cfg, backend=backend)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got_leaves = tree.leaves(cache)
    want_leaves = [w for w in jax.tree_util.tree_leaves(rcache)]
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def _serve(engine_cls, request_cls, params, cfg, prompts, new, **kw):
    eng = engine_cls(params, cfg, **kw)
    for i, (p, n) in enumerate(zip(prompts, new)):
        eng.submit(request_cls(rid=i, prompt=p, max_new_tokens=n))
    return [(r.rid, r.output) for r in eng.run()]


PROMPTS = (5, 13, 3, 12, 7)
NEW_TOKENS = (4, 6, 3, 5, 2)


def _prompts():
    rng = np.random.default_rng(2)
    return [rng.integers(0, ref_smoke(ARCH).vocab_size, n).astype(np.int32)
            for n in PROMPTS]


@functools.lru_cache(maxsize=None)
def _ref_served():
    rp, _, _ = _model()
    return _serve(RefEngine, RefRequest, rp, ref_smoke(ARCH), _prompts(),
                  NEW_TOKENS, slots=2, max_len=32)


@pytest.mark.parametrize("backend", ["torch", "kernels"])
def test_zamba2_engine_matches_reference_engine(backend):
    _, tp, cfg = _model()
    got = _serve(ServeEngine, Request, tp, cfg, _prompts(), NEW_TOKENS,
                 slots=2, max_len=32, backend=backend, device="cpu")
    assert got == _ref_served()


def test_shared_block_gradient_is_the_sum_over_its_uses():
    """``lm_loss`` and every gradient against ``jax.grad``; the shared
    block's gradient is one tensor a leaf, the sum of what each of its
    ``repeats`` uses contributes (checked against the reference's, and
    against a model whose uses each own a copy of the weights)."""
    rp, tp, cfg = _model()
    rng = np.random.default_rng(4)
    batch = {"inputs": rng.integers(0, cfg.vocab_size, (2, 16)).astype(
                 np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (2, 16)).astype(
                 np.int32)}
    (want, _), want_g = jax.value_and_grad(
        lambda p: R.lm_loss(p, {k: jnp.asarray(v) for k, v in batch.items()},
                            ref_smoke(ARCH)), has_aux=True)(rp)
    wrt = tree.tree_map(lambda p: p.detach().requires_grad_(), tp)
    loss, _ = T.lm_loss(wrt, batch, cfg)
    grads = torch.autograd.grad(loss, tree.leaves(wrt))
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-6)
    want_leaves = jax.tree_util.tree_leaves(want_g)
    assert len(grads) == len(want_leaves)
    for g, w in zip(grads, want_leaves):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= GRAD * max(np.abs(w).max(),
                                                         1e-30)
    # Untie the uses: one copy of the shared weights a repeat (no remat,
    # which would replay the uses after the patch is gone).
    copies = [tree.tree_map(lambda p: p.detach().clone().requires_grad_(),
                            tp["shared"]) for _ in range(cfg.repeats)]
    uses = iter(copies)
    orig = T._apply_block

    def untied(p, kind, *a, shared, **kw):
        return orig(p, kind, *a, shared=next(uses) if kind == "shared_attn"
                    else shared, **kw)
    T._apply_block = untied
    try:
        loss_u, _ = T.lm_loss(tp, batch, dataclasses.replace(cfg,
                                                             remat="none"))
    finally:
        T._apply_block = orig
    per_use = [torch.autograd.grad(loss_u, tree.leaves(c), retain_graph=True)
               for c in copies]
    shared_idx = [i for i, (k, _) in enumerate(tree.leaves_with_keys(wrt))
                  if k.startswith("['shared']")]
    for j, i in enumerate(shared_idx):
        total = sum(u[j] for u in per_use)
        torch.testing.assert_close(grads[i], total, rtol=1e-5, atol=1e-6)


def test_remat_covers_mamba_and_shared_bodies_bit_for_bit():
    _, tp, cfg = _model()
    rng = np.random.default_rng(5)
    batch = {"inputs": rng.integers(0, cfg.vocab_size, (2, 12)),
             "targets": rng.integers(0, cfg.vocab_size, (2, 12))}
    out = {}
    for mode in ("none", "full", "dots"):
        wrt = tree.tree_map(lambda p: p.detach().requires_grad_(), tp)
        loss, _ = T.lm_loss(wrt, batch, dataclasses.replace(cfg, remat=mode))
        out[mode] = torch.autograd.grad(loss, tree.leaves(wrt))
    for mode in ("full", "dots"):
        for a, b in zip(out[mode], out["none"]):
            assert torch.equal(a, b)
