"""MLA (DeepSeek's multi-head latent attention) through the port against
the reference, on the CPU: ``mla_forward`` in its explicit form (prefill
and training) and its absorbed form (decode against the compressed
cache, scalar and per-row positions), the absorbed form equal to the
explicit one, the deepseek-v2-lite smoke model's logits on both backends,
prefill and decode, ``ServeEngine`` tokens and finish order against the
reference engine, and ``lm_loss`` gradients against ``jax.grad``.

Parameters come from the reference's initialisers through
``convert.lm_params_from_numpy``; inputs are seeded numpy arrays fed to
both sides.  Logits and attention outputs are held at rtol/atol 2e-5 (the
reference's kernel tolerance; measured <= 5e-6 with fp32 caches),
gradients at 1e-5 of each leaf's largest value (as
``tests/test_torch_lm_train.py``), engine tokens exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import attention as ref_attn
from repro.models import init_model as ref_init
from repro.models import transformer as R
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Request, ServeEngine

ARCH = "deepseek-v2-lite-16b"
TOL = dict(rtol=2e-5, atol=2e-5)
GRAD = 1e-5


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


@functools.lru_cache(maxsize=None)
def _model():
    """(reference params, the port's copy on the CPU, port config)."""
    rp = ref_init(jax.random.PRNGKey(0), ref_smoke(ARCH))
    return rp, lm_params_from_numpy(_np(rp), "cpu"), \
        registry.get_smoke_config(ARCH)


def _tokens(cfg, b, t, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, t)).astype(np.int32)


def _layer(seed=0):
    """One MLA layer's parameters (the reference's init) and inputs."""
    cfg = registry.get_smoke_config(ARCH)
    rp = ref_attn.init_attn_params(jax.random.PRNGKey(seed), ref_smoke(ARCH),
                                   jnp.float32)
    tp = lm_params_from_numpy(_np(rp), "cpu")
    x = np.random.default_rng(seed).standard_normal(
        (2, 7, cfg.d_model)).astype(np.float32)
    return cfg, rp, tp, x


def _inputs(cfg, positions, ci):
    return A.AttnInputs(torch.tensor(np.array(positions)), ci,
                        theta=cfg.rope_theta,
                        head_dim=cfg.mla.qk_rope_head_dim)


def test_mla_explicit_form_matches_reference():
    cfg, rp, tp, x = _layer()
    pos = np.broadcast_to(np.arange(7)[None], (2, 7))
    want, _ = ref_attn.mla_forward(rp, jnp.asarray(x), jnp.asarray(pos),
                                   cfg=ref_smoke(ARCH), cache=None,
                                   cache_index=None, shd=None)
    got, cache = A.mla_forward(tp, torch.from_numpy(x), _inputs(cfg, pos,
                                                                None),
                               cfg=cfg, cache=None)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("index", ["scalar", "per_row"])
def test_mla_absorbed_form_matches_reference(index):
    """The absorbed form writes the compressed latent and the rope key
    into the cache at each row's position and attends over it."""
    cfg, rp, tp, x = _layer(1)
    rcfg = ref_smoke(ARCH)
    s = 16
    ci = 3 if index == "scalar" else np.array([3, 9], np.int32)
    pos = np.arange(7)[None] + np.reshape(ci, (-1, 1))
    pos = np.broadcast_to(pos, (2, 7))
    rcache = ref_attn.init_cache(rcfg, 2, s, jnp.float32)
    # Something already in the cache before the write.
    fill = np.random.default_rng(2)
    rcache = {k: jnp.asarray(fill.standard_normal(v.shape).astype(
        np.float32)) for k, v in rcache.items()}
    want, want_cache = ref_attn.mla_forward(
        rp, jnp.asarray(x), jnp.asarray(pos), cfg=rcfg, cache=rcache,
        cache_index=jnp.asarray(ci), shd=None)
    cache = {k: torch.tensor(np.asarray(v)) for k, v in rcache.items()}
    tci = ci if index == "scalar" else torch.as_tensor(ci).long()
    got, out_cache = A.mla_forward(tp, torch.from_numpy(x),
                                   _inputs(cfg, pos, tci), cfg=cfg,
                                   cache=cache)
    assert out_cache is cache                   # written in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("c_kv", "k_rope"):
        np.testing.assert_allclose(cache[k].numpy(),
                                   np.asarray(want_cache[k]), **TOL)


def test_mla_absorbed_equals_explicit():
    """The reference's property: the absorbed form over a cache written
    from position 0 gives the explicit form's output."""
    cfg, _, tp, x = _layer(3)
    pos = np.broadcast_to(np.arange(7)[None], (2, 7))
    xt = torch.from_numpy(x)
    explicit, _ = A.mla_forward(tp, xt, _inputs(cfg, pos, None), cfg=cfg,
                                cache=None)
    cache = A.init_cache(cfg, 2, 7, torch.float32, torch.device("cpu"))
    absorbed, _ = A.mla_forward(tp, xt, _inputs(cfg, pos, 0), cfg=cfg,
                                cache=cache)
    torch.testing.assert_close(absorbed, explicit, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("backend", ["torch", "kernels"])
def test_deepseek_smoke_forward_matches_reference(backend):
    rp, tp, cfg = _model()
    toks = _tokens(cfg, 2, 13)
    want, _, want_aux = R.forward(rp, jnp.asarray(toks), cfg=ref_smoke(ARCH))
    got, cache, aux = T.forward(tp, toks, cfg=cfg, backend=backend)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5)


@pytest.mark.parametrize("backend", ["torch", "kernels"])
def test_deepseek_prefill_and_decode_match_reference(backend):
    """Prefill into an fp32 cache (the engine's), one decode step at a
    scalar index, then one at per-row indices; the compressed cache
    equal to the reference's."""
    rp, tp, cfg = _model()
    rcfg = ref_smoke(ARCH)
    toks = _tokens(cfg, 2, 11, seed=1)
    want, rcache = R.prefill(rp, jnp.asarray(toks), rcfg, max_len=24,
                             cache_dtype=jnp.float32)
    got, cache = T.prefill(tp, toks, cfg, 24, cache_dtype=torch.float32,
                           backend=backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    tok = np.array([[3], [7]], np.int32)
    want, rcache = R.decode_step(rp, rcache, jnp.asarray(tok), 11, rcfg)
    got, cache = T.decode_step(tp, cache, tok, 11, cfg, backend=backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    idx = np.array([12, 5], np.int32)
    want, rcache = R.decode_step(rp, rcache, jnp.asarray(tok),
                                 jnp.asarray(idx), rcfg)
    got, cache = T.decode_step(tp, cache, tok, idx, cfg, backend=backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("c_kv", "k_rope"):
        np.testing.assert_allclose(cache["blocks"]["s0"][k].numpy(),
                                   np.asarray(rcache["blocks"]["s0"][k]),
                                   **TOL)


def _serve(engine_cls, request_cls, params, cfg, prompts, new, **kw):
    eng = engine_cls(params, cfg, **kw)
    for i, (p, n) in enumerate(zip(prompts, new)):
        eng.submit(request_cls(rid=i, prompt=p, max_new_tokens=n))
    return [(r.rid, r.output) for r in eng.run()]


PROMPTS = (5, 9, 3, 12, 7)
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
def test_deepseek_engine_matches_reference_engine(backend):
    """5 requests through 2 slots (slots refill): tokens and finish order
    equal the reference engine's."""
    _, tp, cfg = _model()
    got = _serve(ServeEngine, Request, tp, cfg, _prompts(), NEW_TOKENS,
                 slots=2, max_len=32, backend=backend, device="cpu")
    assert got == _ref_served()


def test_deepseek_lm_loss_gradients_match_jax_grad():
    """``lm_loss`` (cross entropy and the MoE aux loss) and its gradient
    in every leaf -- MLA's q/kv_down/kv_up/o projections, the dense prefix
    layer, the routed and shared experts -- against ``jax.grad``."""
    rp, tp, cfg = _model()
    rng = np.random.default_rng(4)
    batch = {"inputs": rng.integers(0, cfg.vocab_size, (2, 12)).astype(
                 np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (2, 12)).astype(
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


def test_mla_bf16_logits_lever_matches_reference():
    """``attn_fp32_softmax=False``: MLA's logits in the model's type,
    masked at -3e38, as the reference's."""
    rp, tp, _ = _model()
    cfg = dataclasses.replace(registry.get_smoke_config(ARCH),
                              attn_fp32_softmax=False)
    rcfg = dataclasses.replace(ref_smoke(ARCH), attn_fp32_softmax=False)
    toks = _tokens(cfg, 1, 6)
    want, _, _ = R.forward(rp, jnp.asarray(toks), cfg=rcfg)
    got, _, _ = T.forward(tp, toks, cfg=cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
