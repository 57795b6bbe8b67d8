"""The port's MoE (``models/moe.py``) and the phi3.5-moe smoke model
against the reference, on the CPU.

``moe_forward``'s output, aux loss and gradients with no drops, with
drops (``capacity_factor`` 0.25) and with a shared expert, against the
reference's ``moe_forward`` and ``jax.grad``; ``capacity_for`` over a
sweep; the phi3.5-moe smoke model's tree, logits and aux on both
backends, greedy decode and the serving engine against the reference's.
Routers are seeded random (no ties in top-k).  Parameters come from the
reference's init through numpy.  Tolerances: values rtol 1e-5 / atol
1e-6 (fp32; the dispatch and combine weights are exact one-hots and
gates, so only the expert matmuls' summation order differs), gradients
1e-5 of each leaf's largest value (ROADMAP's ground rule), logits 2e-5
(``tests/test_torch_lm.py``'s), tokens exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.models import config as ref_config
from repro.models import init_model as ref_init
from repro.models import moe as ref_moe
from repro.models import transformer as R
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models import config as port_config
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Request, ServeEngine

ARCH = "phi3.5-moe-42b-a6.6b"
VALUES = dict(rtol=1e-5, atol=1e-6)
LOGITS = dict(rtol=2e-5, atol=2e-5)
GRAD = 1e-5
T_ROW = 32            # 64 (t, k) picks over 4 experts in a row

CASES = {"no_drops": dict(capacity_factor=4.0),
         "drops": dict(capacity_factor=0.25),
         "shared": dict(capacity_factor=1.25, num_shared_experts=1)}


def _cfgs(case):
    """(reference config, port config) of the smoke MoE with ``case``'s
    MoE settings."""
    rcfg = ref_smoke(ARCH)
    rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
        rcfg.moe, **CASES[case]))
    pcfg = registry.get_smoke_config(ARCH)
    pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(
        pcfg.moe, **CASES[case]))
    return rcfg, pcfg


@functools.lru_cache(maxsize=None)
def _layer(case):
    """One MoE layer's params (reference, port) and its input x."""
    rcfg, pcfg = _cfgs(case)
    rp = ref_moe.init_moe_params(jax.random.PRNGKey(1), rcfg, jnp.float32)
    x = np.random.default_rng(4).standard_normal(
        (2, T_ROW, rcfg.d_model)).astype(np.float32)
    return rp, lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, rp),
                                    "cpu"), x, rcfg, pcfg


def _dropped(rp, x, rcfg) -> int:
    """(t, k) picks past their expert's capacity, in numpy."""
    e = rcfg.moe
    logits = x @ np.asarray(rp["router"])
    idx = np.argsort(-logits, axis=-1)[..., :e.top_k]       # [B, T, K]
    cap = ref_moe.capacity_for(x.shape[1], e)
    dropped = 0
    for row in idx:
        seen = np.zeros(e.num_experts, int)
        for ex in row.reshape(-1):                          # t-major
            dropped += seen[ex] >= cap
            seen[ex] += 1
    return dropped


@pytest.mark.parametrize("cf", [0.25, 0.5, 1.0, 1.25, 2.0])
def test_capacity_for_matches_reference(cf):
    for experts, k in ((4, 2), (16, 2), (64, 6), (8, 1)):
        m = port_config.MoEConfig(num_experts=experts, top_k=k,
                                  d_ff_expert=8, capacity_factor=cf)
        rm = ref_config.MoEConfig(num_experts=experts, top_k=k,
                                  d_ff_expert=8, capacity_factor=cf)
        for tokens in (1, 2, 7, 13, 32, 100, 1024, 4099):
            assert moe.capacity_for(tokens, m) == ref_moe.capacity_for(
                tokens, rm)
            assert moe.capacity_for(tokens, m) % 8 == 0


@pytest.mark.parametrize("case", list(CASES))
def test_moe_forward_matches_reference(case):
    rp, tp, x, rcfg, pcfg = _layer(case)
    want, want_aux = ref_moe.moe_forward(rp, jnp.asarray(x), cfg=rcfg)
    got, aux = moe.moe_forward(tp, torch.from_numpy(x), cfg=pcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VALUES)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    assert aux.dtype == torch.float32 and float(aux) > 0
    drops = _dropped(rp, x, rcfg)
    assert (drops > 0) == (case == "drops"), drops


@pytest.mark.parametrize("case", list(CASES))
def test_moe_gradients_match_reference(case):
    rp, tp, x, rcfg, pcfg = _layer(case)
    cot = np.random.default_rng(5).standard_normal(x.shape).astype(
        np.float32)

    def ref_loss(p, xx):
        out, aux = ref_moe.moe_forward(p, xx, cfg=rcfg)
        return jnp.sum(out * cot) + 10.0 * aux

    gp, gx = jax.grad(ref_loss, argnums=(0, 1))(rp, jnp.asarray(x))
    leaves = [v.clone().requires_grad_() for v in tree.leaves(tp)]
    tp_g = dict(zip(sorted(tp), leaves))
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = moe.moe_forward(tp_g, xt, cfg=pcfg)
    got = torch.autograd.grad(torch.sum(out * torch.from_numpy(cot))
                              + 10.0 * aux, leaves + [xt])
    want = [np.asarray(gp[k]) for k in sorted(tp)] + [np.asarray(gx)]
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - w).max() <= GRAD * np.abs(w).max()


@functools.lru_cache(maxsize=None)
def _model():
    rp = ref_init(jax.random.PRNGKey(0), ref_smoke(ARCH))
    return rp, lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, rp),
                                    "cpu")


def test_phi35_init_has_the_reference_tree():
    rp, _ = _model()
    cfg = registry.get_smoke_config(ARCH)
    got = T.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    want = [(jax.tree_util.keystr(p), tuple(v.shape))
            for p, v in jax.tree_util.tree_flatten_with_path(rp)[0]]
    assert [(k, tuple(v.shape)) for k, v in tree.leaves_with_keys(got)] \
        == want
    assert got["blocks"]["s0"]["experts_gate"].shape == (2, 4, 64, 96)
    assert "gate_proj" not in got["blocks"]["s0"]


@pytest.mark.parametrize("backend", ["torch", "kernels"])
def test_phi35_forward_matches_reference(backend):
    rp, tp = _model()
    cfg = registry.get_smoke_config(ARCH)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 13)).astype(np.int32)
    want, _, want_aux = R.forward(rp, jnp.asarray(toks), cfg=ref_smoke(ARCH))
    got, cache, aux = T.forward(tp, toks, cfg=cfg, backend=backend)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    assert float(aux) > 0


def test_phi35_greedy_generate_matches_reference():
    rp, tp = _model()
    cfg = registry.get_smoke_config(ARCH)
    prompt = np.array([[5, 17, 3, 250, 9], [1, 2, 3, 4, 5]], np.int32)
    want = R.greedy_generate(rp, jnp.asarray(prompt), 4, ref_smoke(ARCH))
    got = T.greedy_generate(tp, prompt, 4, cfg, backend="kernels")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _serve(engine_cls, request_cls, params, cfg, prompts, new, **kw):
    eng = engine_cls(params, cfg, **kw)
    for i, (p, n) in enumerate(zip(prompts, new)):
        eng.submit(request_cls(rid=i, prompt=p, max_new_tokens=n))
    return [(r.rid, r.output) for r in eng.run()]


PROMPTS = (5, 9, 3, 12)
NEW_TOKENS = (4, 6, 3, 5)


def _prompts():
    rng = np.random.default_rng(2)
    return [rng.integers(0, 256, n).astype(np.int32) for n in PROMPTS]


@functools.lru_cache(maxsize=None)
def _ref_served():
    return _serve(RefEngine, RefRequest, _model()[0], ref_smoke(ARCH),
                  _prompts(), NEW_TOKENS, slots=2, max_len=32)


@pytest.mark.parametrize("backend", ["torch", "kernels"])
def test_phi35_engine_matches_reference_engine(backend):
    """4 requests through 2 slots (slots refill), tokens and finish order
    equal to the reference engine's."""
    got = _serve(ServeEngine, Request, _model()[1],
                 registry.get_smoke_config(ARCH), _prompts(), NEW_TOKENS,
                 slots=2, max_len=32, backend=backend, device="cpu")
    assert got == _ref_served()
