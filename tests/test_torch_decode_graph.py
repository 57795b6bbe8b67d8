"""The LM decode tick's inputs computed once a forward, and the engine's
fixed-buffer tick, on the CPU at smoke widths.

``transformer.forward`` derives the rope tables, the cache-write indices
and K15's ``kv_len`` once for all its layers (``attention.AttnInputs``).
These tests hold it to a forward that derives them anew in every layer,
bit for bit, on both backends, with and without a cache and with scalar
and per-row cache indices; the tables to ``layers.rope``.  The engine's
tick runs eagerly on its fixed buffers here (the CUDA graph is the
card's: ``tests/test_torch_gpu.py``).  The reference-engine parity of the
same tick is ``tests/test_torch_lm.py::test_engine_matches_reference_engine``.
No JAX: everything here compares the port with itself.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import registry
from repro_torch.core import faults
from repro_torch.kernels import rmsnorm as k16
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Request, ServeEngine

_PARAMS: dict = {}


def _model(arch="gemma2-9b"):
    if arch not in _PARAMS:
        cfg = registry.get_smoke_config(arch)
        _PARAMS[arch] = cfg, T.init_model(torch.Generator().manual_seed(0),
                                          cfg, device="cpu")
    return _PARAMS[arch]


def _tokens(cfg, b, t, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, t))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rope_tables_equal_rope_per_call(dtype):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 5, 3, 16),
                                             np.float32)).to(dtype)
    pos = torch.tensor([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]])
    inputs = attn.AttnInputs(pos, None, theta=10000.0, head_dim=16)
    got = layers.apply_rope(x, *inputs.rope(dtype))
    assert torch.equal(got, layers.rope(x, pos, 10000.0))
    assert inputs.rope(dtype)[0] is inputs.rope(dtype)[0]    # computed once


def _per_layer(monkeypatch):
    """Make every layer derive its inputs anew, as before the hoist."""
    real = attn.gqa_forward

    def fresh(params, x, inputs, **kw):
        again = attn.AttnInputs(inputs.positions, inputs.cache_index,
                                theta=inputs.theta, head_dim=inputs.head_dim)
        return real(params, x, again, **kw)
    monkeypatch.setattr(attn, "gqa_forward", fresh)


@pytest.mark.parametrize("backend", ["torch", "kernels"])
@pytest.mark.parametrize("case", ["no_cache", "prefill", "decode_scalar",
                                  "decode_per_row"])
def test_forward_once_a_forward_equals_once_a_layer(monkeypatch, backend,
                                                    case):
    cfg, params = _model()
    toks = _tokens(cfg, 2, 11)
    with torch.no_grad():
        _, warm = T.prefill(params, toks, cfg, 24, backend=backend)
    tok = np.array([[3], [7]])
    calls = {
        "no_cache": lambda c: T.forward(params, toks, cfg=cfg,
                                        backend=backend)[0],
        "prefill": lambda c: T.forward(params, toks, cfg=cfg, cache=c,
                                       cache_index=0, backend=backend)[0],
        "decode_scalar": lambda c: T.decode_step(params, c, tok, 11, cfg,
                                                 backend=backend)[0],
        "decode_per_row": lambda c: T.decode_step(
            params, c, tok, np.array([12, 5]), cfg, backend=backend)[0],
    }
    caches = [{k: v if k != "blocks" else {s: {n: t.clone()
                                               for n, t in c.items()}
                                           for s, c in v.items()}
               for k, v in warm.items()} for _ in range(2)]
    with torch.no_grad():
        got = calls[case](caches[0])
        with monkeypatch.context() as m:
            _per_layer(m)
            want = calls[case](caches[1])
    assert torch.equal(got, want)
    for leaf in ("k", "v"):
        assert torch.equal(caches[0]["blocks"]["s0"][leaf],
                           caches[1]["blocks"]["s0"][leaf])


def test_engine_tick_runs_on_its_fixed_buffers_on_the_cpu():
    cfg, params = _model()
    eng = ServeEngine(params, cfg, slots=2, max_len=32, backend="kernels",
                      device="cpu")
    for i, n in enumerate((5, 9, 3)):
        eng.submit(Request(rid=i, prompt=_tokens(cfg, 1, n, seed=i)[0]
                           .astype(np.int32), max_new_tokens=5))
    eng.step()
    eng.step()
    assert eng.tick_kinds == {"eager": 2} and not eng.cuda_graph
    assert eng.last_tick == "eager" and eng.graph_replays == 0
    emitted = [r.output[-1] for r in eng.active]
    assert eng._argmax.tolist() == emitted
    assert torch.equal(eng._argmax, eng._logits.argmax(-1))
    assert eng._lengths.tolist() == [n - 1 for n in eng.lengths]
    eng.run()
    assert eng.tick_kinds == {"eager": eng.ticks}


def test_an_injected_fault_reaches_the_engines_tick():
    cfg, params = _model()
    eng = ServeEngine(params, cfg, slots=1, max_len=32, backend="kernels",
                      device="cpu")
    eng.submit(Request(rid=0, prompt=_tokens(cfg, 1, 4)[0].astype(np.int32),
                       max_new_tokens=4))
    eng.step()
    assert torch.isfinite(eng._logits).all()
    spec = faults.FaultSpec(site=faults.SITE_RMSNORM, kind="nan_output",
                            times=10 ** 6)
    with faults.inject(spec) as reg:
        eng.step()
    assert reg.count() > 0 and torch.isnan(eng._logits).all()


@pytest.mark.parametrize("d,vec,threads", [
    (3584, 4, 512), (3584, 8, 512), (3584, 1, 512), (4096, 4, 512),
    (4100, 4, 1024), (8192, 4, 1024), (8192, 8, 512), (8192, 1, 1024),
    (384, 4, k16.WARP_ROWS), (1024, 1, k16.WARP_ROWS), (1025, 1, 512)])
def test_rmsnorm_form_is_planned_from_the_shapes(d, vec, threads):
    assert k16.plan(d, vec) == threads
    if threads != k16.WARP_ROWS:
        per = -(-(d // vec) // threads)
        assert per <= (k16.VECTORS_A_THREAD if vec > 1
                       else k16.ELEMENTS_A_THREAD)
