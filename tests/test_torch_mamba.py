"""Mamba2 (SSD) through the port against the reference, on the CPU:
``ssd_chunked`` at multiples of the chunk, at a prime length (chunks of
1) and from a state, ``ssd_recurrent_step``, the causal conv with and
without a tail, ``mamba_forward`` without a cache, with one (the chunked
form from a state) and one token at a time (the recurrent form); the
masked-exp deviation; the mamba2-370m smoke model's logits on both
backends, prefill and decode, ``ServeEngine`` tokens and finish order
against the reference engine with more requests than slots, a refilled
slot against a fresh engine, and ``lm_loss`` gradients against
``jax.grad``.

Parameters come from the reference's initialisers through
``convert.lm_params_from_numpy``; inputs are seeded numpy arrays fed to
both sides.  Values are held at rtol/atol 2e-5 (the reference's kernel
tolerance; measured <= 3e-6), gradients at 1e-5 of each leaf's largest
value (as ``tests/test_torch_lm_train.py``), engine tokens exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import init_model as ref_init
from repro.models import mamba as RM
from repro.models import transformer as R
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import mamba as M
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Request, ServeEngine

ARCH = "mamba2-370m"
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


def _ssd_inputs(t, seed=0, a_range=(0.01, 0.5), b=2, h=3, p=4, n=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, h, p)).astype(np.float32)
    a = -rng.uniform(*a_range, (b, t, h)).astype(np.float32)
    bm = rng.standard_normal((b, t, h, n)).astype(np.float32)
    cm = rng.standard_normal((b, t, h, n)).astype(np.float32)
    h0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return x, a, bm, cm, h0


def _leaves_close(got, want, tol=GRAD):
    for g, w in zip(got, want, strict=True):
        w = np.asarray(w, np.float32)
        g = g.detach().numpy()
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1e-30)


# ---------------------------------------------------------------------------
# The SSD scan, the recurrent step, the conv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t,state", [(16, False), (24, True), (13, False),
                                     (13, True), (6, False)],
                         ids=["two_chunks", "three_chunks_h0", "prime",
                              "prime_h0", "short"])
def test_ssd_chunked_matches_reference(t, state):
    """Chunk 8: two and three whole chunks, a prime length (the chunk
    rule halves 8 down to 1: thirteen chunks of 1), a length under the
    chunk; with and without a starting state."""
    x, a, bm, cm, h0 = _ssd_inputs(t)
    assert M.chunk_length(13, 8) == 1 and M.chunk_length(24, 8) == 8
    want_y, want_h = RM.ssd_chunked(jnp.asarray(x), jnp.asarray(a),
                                    jnp.asarray(bm), jnp.asarray(cm), 8,
                                    jnp.asarray(h0) if state else None)
    got_y, got_h = M.ssd_chunked(*map(torch.from_numpy, (x, a, bm, cm)), 8,
                                 torch.from_numpy(h0) if state else None)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)


def test_ssd_recurrent_step_matches_reference_and_continues_the_scan():
    x, a, bm, cm, h0 = _ssd_inputs(1, seed=1)
    want_y, want_h = RM.ssd_recurrent_step(*map(jnp.asarray,
                                                (x, a, bm, cm, h0)))
    got_y, got_h = M.ssd_recurrent_step(*map(torch.from_numpy,
                                             (x, a, bm, cm, h0)))
    assert got_h.dtype == torch.float32
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)
    # Steps one at a time from h0 give the chunked scan from h0.
    x, a, bm, cm, h0 = _ssd_inputs(9, seed=2)
    xt, at, bt, ct = map(torch.from_numpy, (x, a, bm, cm))
    state, ys = torch.from_numpy(h0), []
    for i in range(9):
        y, state = M.ssd_recurrent_step(xt[:, i:i + 1], at[:, i:i + 1],
                                        bt[:, i:i + 1], ct[:, i:i + 1],
                                        state)
        ys.append(y)
    y_all, h_all = M.ssd_chunked(xt, at, bt, ct, 4, torch.from_numpy(h0))
    torch.testing.assert_close(torch.cat(ys, 1), y_all, **TOL)
    torch.testing.assert_close(state, h_all, **TOL)


@pytest.mark.parametrize("tail", [False, True])
def test_causal_conv_matches_reference(tail):
    rng = np.random.default_rng(3)
    xbc = rng.standard_normal((2, 7, 10)).astype(np.float32)
    w = rng.standard_normal((10, 4)).astype(np.float32)
    b = rng.standard_normal(10).astype(np.float32)
    tl = rng.standard_normal((2, 3, 10)).astype(np.float32) if tail else None
    want, want_tail = RM._causal_conv(jnp.asarray(xbc), jnp.asarray(w),
                                      jnp.asarray(b),
                                      None if tl is None else jnp.asarray(tl))
    got, got_tail = M._causal_conv(
        torch.from_numpy(xbc), torch.from_numpy(w), torch.from_numpy(b),
        None if tl is None else torch.from_numpy(tl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(got_tail.numpy(), np.asarray(want_tail))


@pytest.mark.parametrize("mode", ["no_cache", "chunked_from_state",
                                  "recurrent"])
def test_mamba_forward_matches_reference(mode):
    """One block, the reference's init: without a cache; with a cache
    holding a state (a 9-token chunked call); one token (the recurrent
    step).  The cache is written in place, fp32, as the reference's."""
    cfg = registry.get_smoke_config(ARCH)
    rcfg = ref_smoke(ARCH)
    rp = RM.init_mamba_block(jax.random.PRNGKey(5), rcfg, jnp.float32)
    tp = lm_params_from_numpy(_np(rp), "cpu")
    rng = np.random.default_rng(6)
    t = 1 if mode == "recurrent" else 9
    x = rng.standard_normal((2, t, cfg.d_model)).astype(np.float32)
    cache = rcache = None
    if mode != "no_cache":
        rcache = RM.init_mamba_cache(rcfg, 2, jnp.float32)
        rcache = {k: jnp.asarray(0.3 * rng.standard_normal(v.shape).astype(
            np.float32)) for k, v in rcache.items()}
        cache = {k: torch.tensor(np.asarray(v)) for k, v in rcache.items()}
    want, want_cache = RM.mamba_forward(rp, jnp.asarray(x), cfg=rcfg,
                                        cache=rcache)
    got, got_cache = M.mamba_forward(tp, torch.from_numpy(x), cfg=cfg,
                                     cache=cache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if cache is not None:
        assert got_cache is cache
        for k in ("conv", "ssd"):
            assert cache[k].dtype == torch.float32
            np.testing.assert_allclose(cache[k].numpy(),
                                       np.asarray(want_cache[k]), **TOL)


# ---------------------------------------------------------------------------
# The deviation: the masked exp keeps the gradient finite
# ---------------------------------------------------------------------------

def _cotangents(seed=8):
    """Fixed weights of y [1, 128, 2, 4] and the state [1, 2, 4, 5]: the
    loss is linear, so a gradient's error is its backward's alone."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, 128, 2, 4)).astype(np.float32),
            rng.standard_normal((1, 2, 4, 5)).astype(np.float32))


def _ssd_grads_ref(x, a, bm, cm):
    gy, gh = map(jnp.asarray, _cotangents())

    def loss(x, a, bm, cm):
        y, h = RM.ssd_chunked(x, a, bm, cm, 128)
        return jnp.sum(y * gy) + jnp.sum(h * gh)
    return jax.grad(loss, argnums=(0, 1, 2, 3))(*map(jnp.asarray,
                                                     (x, a, bm, cm)))


def _ssd_grads_port(x, a, bm, cm):
    gy, gh = map(torch.from_numpy, _cotangents())
    args = [torch.from_numpy(v).requires_grad_() for v in (x, a, bm, cm)]
    y, h = M.ssd_chunked(*args, 128)
    return torch.autograd.grad(torch.sum(y * gy) + torch.sum(h * gh), args)


@pytest.mark.parametrize("decay", [0.1, 1.0])
def test_ssd_masked_exp_deviation(decay):
    """One 128-step chunk at ``a = -decay`` every step.  The two ways of
    building the decay matrix give the same bits; the port's forward
    matches the reference's.  At ``a = -0.1`` (``exp`` above the diagonal
    peaks at e^12.7) every gradient equals the reference's; at ``a = -1``
    the reference's ``exp`` overflows above the diagonal and its gradient
    in ``a`` is NaN, while the port's is finite and its gradients in x, B
    and C (finite in the reference) equal the reference's."""
    x, _, bm, cm, _ = _ssd_inputs(128, seed=7, b=1, h=2)
    a = np.full((1, 128, 2), -decay, np.float32)
    cs = torch.cumsum(torch.from_numpy(a).permute(0, 2, 1), -1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((128, 128), dtype=torch.bool))
    assert torch.equal(torch.exp(diff.masked_fill(~mask, float("-inf"))),
                       torch.where(mask, torch.exp(diff), 0.0))
    want_y, _ = RM.ssd_chunked(*map(jnp.asarray, (x, a, bm, cm)), 128)
    got_y, _ = M.ssd_chunked(*map(torch.from_numpy, (x, a, bm, cm)), 128)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), **TOL)

    want = _ssd_grads_ref(x, a, bm, cm)
    got = _ssd_grads_port(x, a, bm, cm)
    assert all(torch.isfinite(g).all() for g in got)
    if decay == 1.0:
        assert np.isnan(np.asarray(want[1])).any()       # the reference's
        _leaves_close([got[0], got[2], got[3]], [want[0], want[2], want[3]])
    else:
        assert all(np.isfinite(np.asarray(w)).all() for w in want)
        _leaves_close(got, want)


# ---------------------------------------------------------------------------
# The mamba2-370m smoke model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["torch", "kernels"])
def test_mamba2_smoke_forward_matches_reference(backend):
    rp, tp, cfg = _model()
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (2, 13)).astype(np.int32)
    want, _, _ = R.forward(rp, jnp.asarray(toks), cfg=ref_smoke(ARCH))
    got, cache, aux = T.forward(tp, toks, cfg=cfg, backend=backend)
    assert cache is None and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("backend", ["torch", "kernels"])
def test_mamba2_prefill_and_decode_match_reference(backend):
    """A prime-length prefill (chunks of 1), then decode steps at a scalar
    and at per-row indices (the recurrent step ignores positions); the
    states equal the reference's."""
    rp, tp, cfg = _model()
    rcfg = ref_smoke(ARCH)
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                             (2, 11)).astype(np.int32)
    want, rcache = R.prefill(rp, jnp.asarray(toks), rcfg, max_len=24)
    got, cache = T.prefill(tp, toks, cfg, 24, backend=backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    tok = np.array([[3], [7]], np.int32)
    for idx in (11, np.array([12, 5], np.int32)):
        want, rcache = R.decode_step(rp, rcache, jnp.asarray(tok),
                                     jnp.asarray(idx), rcfg)
        got, cache = T.decode_step(tp, cache, tok, idx, cfg, backend=backend)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("conv", "ssd"):
        np.testing.assert_allclose(cache["blocks"]["s0"][k].numpy(),
                                   np.asarray(rcache["blocks"]["s0"][k]),
                                   **TOL)


def _serve(engine_cls, request_cls, params, cfg, prompts, new, **kw):
    eng = engine_cls(params, cfg, **kw)
    for i, (p, n) in enumerate(zip(prompts, new)):
        eng.submit(request_cls(rid=i, prompt=p, max_new_tokens=n))
    return [(r.rid, r.output) for r in eng.run()]


PROMPTS = (13, 4, 9, 16, 7, 5)          # 13, 7, 5: prime
NEW_TOKENS = (4, 6, 3, 5, 2, 4)


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
def test_mamba2_engine_matches_reference_engine(backend):
    """6 requests through 2 slots (each refilled twice): tokens and finish
    order equal the reference engine's, which prefills each request into
    a fresh cache."""
    _, tp, cfg = _model()
    got = _serve(ServeEngine, Request, tp, cfg, _prompts(), NEW_TOKENS,
                 slots=2, max_len=32, backend=backend, device="cpu")
    assert got == _ref_served()


def test_mamba_refill_equals_a_fresh_engine():
    """A request refilling the slot a longer one held returns what it
    returns in a fresh engine: the prefill starts from a zero state, not
    from the last request's conv tail and SSD state (which every tick
    also advanced)."""
    _, tp, cfg = _model()
    rng = np.random.default_rng(3)
    long_p = rng.integers(0, cfg.vocab_size, 20).astype(np.int32)
    short_p = rng.integers(0, cfg.vocab_size, 5).astype(np.int32)
    kw = dict(slots=1, max_len=40, backend="kernels", device="cpu")
    both = _serve(ServeEngine, Request, tp, cfg, [long_p, short_p], [8, 6],
                  **kw)
    alone = _serve(ServeEngine, Request, tp, cfg, [short_p], [6], **kw)
    assert both[1][1] == alone[0][1]
    eng = ServeEngine(tp, cfg, **kw)
    eng.submit(Request(rid=0, prompt=long_p, max_new_tokens=8))
    eng.run()
    assert eng.cache["blocks"]["s0"]["ssd"].abs().sum() > 0   # left behind


def test_mamba2_lm_loss_gradients_match_jax_grad():
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
    _leaves_close(grads, jax.tree_util.tree_leaves(want_g))
