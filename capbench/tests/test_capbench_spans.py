"""The serving layer's metrics read from the program's spans: each reader
gives a number on a smoke window driven under the CPU profiler, and
nothing where the program recorded nothing or has no spans at all."""

import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from capbench import harness, inputs, spec, trace
from capbench.tests import helpers
from repro_torch import obs

READERS = {"mnist-offline": ["tick_host_ms.offline", "dispatch_ms.offline"],
           "mnist-server": ["tick_host_ms.server",
                            "queue_wait_p95_ms.server"]}
EMPTY = dict(window={}, trace={"busy_s": 0.0, "window_s": 0.0}, cell={},
             cfg={})


@pytest.fixture(autouse=True)
def clean():
    obs.reset()
    yield
    obs.reset()


def driver(name: str, seed: int = 7):
    cell = helpers.smoke_cell(name)
    cfg = inputs.smoke(cell.config)
    dev = torch.device("cpu")
    x, y = inputs.images(cfg, helpers.POOL, seed, dev)
    ctx = harness.Ctx(cfg=cfg, pcfg=inputs.program_config(cfg), mix=cell.mix,
                      params=cell.params, limits=cell.limits, device=dev,
                      seed=seed, weights=inputs.weights(cfg, seed, dev),
                      images=x, labels=y)
    return spec.driver(cell.mix["driver"])(ctx)


@pytest.mark.parametrize("cell", sorted(READERS))
def test_readers_on_a_profiled_smoke_window(cell):
    d = driver(cell)
    assert obs.snapshot().spans == []       # set-up ran unprofiled
    with profile(activities=[ProfilerActivity.CPU]):
        rec = d.window(helpers.WINDOW_S, trace.span)
    d.drain()                               # unprofiled: adds nothing
    got = {m: spec.reader(m)(dict(EMPTY, window=rec)) for m in READERS[cell]}
    for name, value in got.items():
        assert isinstance(value, float) and value >= 0, (name, value)
    steps = [s for s in obs.snapshot().spans if s.name == "engine.step"]
    assert len(steps) == rec["ticks"]
    if cell == "mnist-offline":
        # The host's work a tick holds the dispatch.
        assert got["tick_host_ms.offline"] >= got["dispatch_ms.offline"] > 0
    else:
        waits = obs.snapshot().samples["engine.queue_wait_s"]
        assert len(waits) >= rec["images"]


@pytest.mark.parametrize("metric", [m for ms in READERS.values()
                                    for m in ms])
def test_a_span_reader_without_the_program_s_spans_returns_none(
        metric, monkeypatch):
    assert spec.reader(metric)(EMPTY) is None   # nothing recorded
    import repro_torch
    monkeypatch.delattr(repro_torch, "obs")
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    assert spec.reader(metric)(EMPTY) is None   # a program without obs


def test_the_new_entries_name_existing_cells_and_readers():
    bench = spec.benchmark()
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        if m["name"].split(".")[0] in ("tick_host_ms", "dispatch_ms",
                                       "queue_wait_p95_ms"):
            assert m["layer"] == "serving" and set(m["workloads"]) <= cells
            assert callable(spec.reader(m["name"]))
