"""The port's LM family against the reference at smoke widths: the dense
archs' forward on both backends, prefill and decode with scalar and
per-row cache positions, the slot-based ``ServeEngine``, and the registry.

Weights come from ``repro.models.init_model`` and move over through
``lm_params_from_numpy``; tokens are made with numpy from a seed.  The
port runs on the CPU, where ``backend="kernels"`` runs the plain twins of
K15 and K16.  Logits are held at rtol/atol 2e-5 (the reference's kernel
tolerance; the measured gap is under 4e-6), engine tokens and finish
order exactly.
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
from repro.models import transformer as R
from repro.serve import Request as RefRequest
from repro.serve import ServeEngine as RefEngine
from repro_torch.configs import registry
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import build
from repro_torch.models import config as port_config
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Request, ServeEngine

ARCHS = ("gemma2-9b", "granite-3-2b", "gemma-7b", "gemma3-12b",
         "chameleon-34b")
REFUSED = ("mamba2-370m", "hubert-xlarge", "phi3.5-moe-42b-a6.6b",
           "deepseek-v2-lite-16b", "zamba2-1.2b")
TOL = dict(rtol=2e-5, atol=2e-5)

_PARAMS: dict = {}


def _params(arch):
    """(reference params, the port's copy on the CPU, port config)."""
    if arch not in _PARAMS:
        rp = ref_init(jax.random.PRNGKey(0), ref_smoke(arch))
        tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, rp),
                                  "cpu")
        _PARAMS[arch] = rp, tp, registry.get_smoke_config(arch)
    return _PARAMS[arch]


@functools.lru_cache(maxsize=None)
def _ref_forward(arch):
    """The reference's logits on ``_tokens(cfg, 2, 13)``, once per arch."""
    rp, _, cfg = _params(arch)
    return np.asarray(R.forward(rp, jnp.asarray(_tokens(cfg, 2, 13)),
                                cfg=ref_smoke(arch))[0])


def _tokens(cfg, b, t, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, t)).astype(np.int32)


@pytest.mark.parametrize("backend", ["torch", "kernels"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch, backend):
    _, tp, cfg = _params(arch)
    toks = _tokens(cfg, 2, 13)     # > gemma's window of 8: it masks
    got, cache, aux = T.forward(tp, toks, cfg=cfg, backend=backend)
    assert cache is None and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), _ref_forward(arch), **TOL)


def test_kernels_backend_launches_the_wrappers_once_per_site(monkeypatch):
    """Every attention goes through K15's wrapper and every fp32 norm
    through K16's: 4 norms per gemma2 layer (post-norms) and the final."""
    from repro_torch.kernels import ops
    calls = {"rmsnorm": 0, "flash_attention": 0}
    for name in calls:
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    _, tp, cfg = _params("gemma2-9b")
    T.forward(tp, _tokens(cfg, 1, 5), cfg=cfg, backend="kernels")
    assert calls == {"rmsnorm": 4 * cfg.num_layers + 1,
                     "flash_attention": cfg.num_layers}


@pytest.mark.parametrize("arch", ["gemma2-9b", "granite-3-2b"])
@pytest.mark.parametrize("backend", ["torch", "kernels"])
def test_prefill_and_decode_match_reference(arch, backend):
    """Prefill into a bf16 cache (the reference's default), one decode
    step at a scalar index, then one at per-row indices."""
    rp, tp, cfg = _params(arch)
    rcfg = ref_smoke(arch)
    toks = _tokens(cfg, 2, 11, seed=1)
    want, rcache = R.prefill(rp, jnp.asarray(toks), rcfg, max_len=24)
    got, cache = T.prefill(tp, toks, cfg, 24, backend=backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    kr = np.asarray(rcache["blocks"]["s0"]["k"].astype(jnp.float32))
    np.testing.assert_allclose(cache["blocks"]["s0"]["k"].float().numpy(),
                               kr, rtol=2 ** -7, atol=1e-5)

    tok = np.array([[3], [7]], np.int32)
    want, rcache = R.decode_step(rp, rcache, jnp.asarray(tok), 11, rcfg)
    got, cache = T.decode_step(tp, cache, tok, 11, cfg, backend=backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    idx = np.array([12, 5], np.int32)       # rows at different lengths
    want, rcache = R.decode_step(rp, rcache, jnp.asarray(tok),
                                 jnp.asarray(idx), rcfg)
    got, cache = T.decode_step(tp, cache, tok, idx, cfg, backend=backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for leaf in ("k", "v"):         # bf16: values 2e-5 apart may round
        np.testing.assert_allclose(     # one bf16 ulp (2^-8) apart
            cache["blocks"]["s0"][leaf].float().numpy(),
            np.asarray(rcache["blocks"]["s0"][leaf].astype(jnp.float32)),
            rtol=2 ** -7, atol=1e-5)


def test_greedy_generate_matches_reference():
    rp, tp, cfg = _params("granite-3-2b")
    prompt = np.array([[1, 2, 3, 4]], np.int32)
    want = R.greedy_generate(rp, jnp.asarray(prompt), 3, ref_smoke(
        "granite-3-2b"))
    got = T.greedy_generate(tp, prompt, 3, cfg, backend="kernels")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _serve(engine_cls, request_cls, params, cfg, prompts, new, **kw):
    eng = engine_cls(params, cfg, **kw)
    for i, (p, n) in enumerate(zip(prompts, new)):
        eng.submit(request_cls(rid=i, prompt=p, max_new_tokens=n))
    return [(r.rid, r.output) for r in eng.run()]


ENGINE_CASES = {"granite-3-2b": (5, 9, 3, 12, 7),
                "gemma2-9b": (12, 3, 17, 10, 6)}   # past the window of 8
NEW_TOKENS = (4, 6, 3, 5, 2)


def _prompts(arch):
    rng = np.random.default_rng(2)
    return [rng.integers(0, ref_smoke(arch).vocab_size, n).astype(np.int32)
            for n in ENGINE_CASES[arch]]


@functools.lru_cache(maxsize=None)
def _ref_served(arch):
    """The reference engine's (rid, tokens) in finish order, once per
    arch: 5 requests through 2 slots, so slots refill."""
    rp, _, _ = _params(arch)
    return _serve(RefEngine, RefRequest, rp, ref_smoke(arch), _prompts(arch),
                  NEW_TOKENS, slots=2, max_len=32)


@pytest.mark.parametrize("arch", list(ENGINE_CASES))
@pytest.mark.parametrize("backend", ["torch", "kernels"])
def test_engine_matches_reference_engine(arch, backend):
    _, tp, cfg = _params(arch)
    got = _serve(ServeEngine, Request, tp, cfg, _prompts(arch), NEW_TOKENS,
                 slots=2, max_len=32, backend=backend, device="cpu")
    assert got == _ref_served(arch)         # tokens and finish order


def test_engine_refill_never_reads_the_last_requests_cache():
    """A short request refilling the slot a long one held returns what it
    returns in a fresh engine: the long request's K/V past the new prompt
    stay in the cache but weigh nothing."""
    _, tp, cfg = _params("gemma2-9b")
    rng = np.random.default_rng(3)
    long_p = rng.integers(0, cfg.vocab_size, 20).astype(np.int32)
    short_p = rng.integers(0, cfg.vocab_size, 3).astype(np.int32)
    kw = dict(slots=1, max_len=32, backend="kernels", device="cpu")
    both = _serve(ServeEngine, Request, tp, cfg, [long_p, short_p], [8, 6],
                  **kw)
    alone = _serve(ServeEngine, Request, tp, cfg, [short_p], [6], **kw)
    assert both[1][1] == alone[0][1]
    eng = ServeEngine(tp, cfg, **kw)
    eng.submit(Request(rid=0, prompt=long_p, max_new_tokens=8))
    eng.run()
    assert eng.cache["blocks"]["s0"]["k"][:, 0, 10:27].abs().sum() > 0


def test_engine_eos_stops_early_and_refuses_bad_prompts():
    _, tp, cfg = _params("granite-3-2b")
    kw = dict(slots=1, max_len=16, device="cpu")
    prompt = np.arange(4, dtype=np.int32)
    first = _serve(ServeEngine, Request, tp, cfg, [prompt], [8], **kw)
    eng = ServeEngine(tp, cfg, **kw)
    eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=8,
                       eos_id=first[0][1][0]))
    assert len(eng.run()[0].output) == 1
    with pytest.raises(ValueError, match="prompt"):
        eng.submit(Request(rid=1, prompt=np.arange(17, dtype=np.int32)))


def test_engine_times_its_prefills_and_ticks():
    _, tp, cfg = _params("granite-3-2b")
    build.reset_launch_counts()
    eng = ServeEngine(tp, cfg, slots=2, max_len=16, device="cpu")
    for i in range(3):
        eng.submit(Request(rid=i, prompt=np.arange(3, dtype=np.int32),
                           max_new_tokens=3))
    eng.run()
    assert len(eng.timings["prefill_s"]) == 3
    assert len(eng.timings["decode_s"]) == eng.ticks > 0
    assert all(build.launch_counts()[k] == 0
               for k in ("rmsnorm", "flash_attention"))   # CPU: twins


# ---------------------------------------------------------------------------
# Registry, configs, refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS + REFUSED)
def test_registry_resolves_the_dense_archs_and_refuses_the_rest(arch):
    from repro.configs import registry as ref_registry
    if arch in REFUSED:
        with pytest.raises(KeyError, match="ROADMAP queue 1, item 11"):
            registry.get_config(arch)
        return
    for get, ref_get in ((registry.get_config, ref_registry.get_config),
                         (registry.get_smoke_config,
                          ref_registry.get_smoke_config)):
        cfg = get(arch)
        assert isinstance(cfg, port_config.ModelConfig)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_get(arch))
        assert port_config.count_params(cfg) == ref_config.count_params(
            ref_get(arch))


def test_gemma2_9b_counts_its_published_size():
    cfg = registry.get_config("gemma2-9b")
    assert (cfg.num_layers, cfg.d_model, cfg.head_dim) == (42, 3584, 256)
    assert port_config.count_params(cfg) == 9_241_705_984


@pytest.mark.parametrize("part,item", [
    (dict(moe=port_config.MoEConfig(num_experts=4, top_k=2,
                                    d_ff_expert=32)), "11b"),
    (dict(mla=port_config.MLAConfig()), "11c"),
    (dict(pattern=("mamba",), ssm=port_config.SSMConfig()), "11d"),
    (dict(frontend="audio_frames"), "11e"),
])
def test_unported_parts_name_their_roadmap_item(part, item):
    cfg = dataclasses.replace(registry.get_smoke_config("granite-3-2b"),
                              **part)
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        T.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")


def test_bf16_logits_lever_is_plain_only():
    """``attn_fp32_softmax=False`` (the reference's bf16-logits lever) has
    no kernel: the kernels backend refuses it, the plain one runs it."""
    rp, tp, _ = _params("granite-3-2b")
    cfg = dataclasses.replace(registry.get_smoke_config("granite-3-2b"),
                              attn_fp32_softmax=False)
    rcfg = dataclasses.replace(ref_smoke("granite-3-2b"),
                               attn_fp32_softmax=False)
    toks = _tokens(cfg, 1, 6)
    with pytest.raises(ValueError, match="fp32 statistics"):
        T.forward(tp, toks, cfg=cfg, backend="kernels")
    want, _, _ = R.forward(rp, jnp.asarray(toks), cfg=rcfg)
    got, _, _ = T.forward(tp, toks, cfg=cfg, backend="torch")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_init_model_draws_the_reference_shapes_on_the_device():
    rp, _, cfg = _params("gemma2-9b")
    tp = T.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), rp)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), tp) == shapes
    assert float(tp["blocks"]["s0"]["input_norm"].abs().sum()) == 0.0
