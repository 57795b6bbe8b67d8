"""The traffic, the cells' files and the readers, on the CPU."""

import json
import shutil

import numpy as np
import pytest

from capbench import spec
from capbench.drivers import serve
from capbench.tests import helpers


def test_poisson_schedule_repeats_from_the_seed():
    a = serve.arrival_offsets(8000.0, 10.0, 3_000_000_123)
    b = serve.arrival_offsets(8000.0, 10.0, 3_000_000_123)
    assert np.array_equal(a, b)
    assert len(a) == 80_000
    assert np.all(np.diff(a) >= 0) and 0 < a[0] and a[-1] < 10.0


def test_every_seed_offers_the_same_gaps_in_another_order():
    a = serve.arrival_offsets(8000.0, 10.0, 1)
    b = serve.arrival_offsets(8000.0, 10.0, 2)
    assert not np.array_equal(a, b)
    gaps = np.sort(serve.arrival_gaps(8000.0, 10.0))
    for offsets in (a, b):
        # The gaps before each arrival and the one after the last.
        got = np.diff(offsets, prepend=0.0, append=10.0)
        np.testing.assert_allclose(np.sort(got), gaps, rtol=0, atol=1e-9)
    assert abs(np.mean(gaps) - 1 / 8000.0) < 1e-6


def test_offline_backlog_stays_at_twice_the_slots():
    import torch

    from capbench import harness, inputs, trace
    cell = helpers.smoke_cell("mnist-offline")
    cfg = inputs.smoke(cell.config)
    dev = torch.device("cpu")
    x, y = inputs.images(cfg, helpers.POOL, 9, dev)
    ctx = harness.Ctx(cfg=cfg, pcfg=inputs.program_config(cfg), mix=cell.mix,
                      params=dict(cell.params, slots=4, pool=helpers.POOL),
                      limits=cell.limits, device=dev, seed=9,
                      weights=inputs.weights(cfg, 9, dev), images=x, labels=y)
    driver = serve.Driver(ctx)
    seen = []
    step = driver.engine.step

    def counted():
        seen.append(len(driver.engine.queue))
        return step()
    driver.engine.step = counted
    rec = driver.window(0.05, trace.no_span)
    assert seen and set(seen) == {8}         # 2 x 4 slots before each tick
    assert rec["ticks"] == len(seen) and rec["occupancy"] == 1.0
    driver.drain()                           # the backlog left is served
    attempted, failed = driver.counts()
    assert failed == 0 and attempted == rec["images"] + 4


def test_a_new_cell_file_is_found_by_name(tmp_path):
    """A cell that later work adds is a new file and a new entry: no file
    of the benchmark changes."""
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({
        "name": "mnist-offline-s8", "config": "capsnet-mnist",
        "traffic": "offline", "chips": 1, "why": "slots 8"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    shutil.copytree(spec.HERE, tmp_path / "capbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "capbench" / "workloads" / "mnist-offline-s8.json"
     ).write_text(json.dumps({
         "config": "capsnet-mnist", "mix": "offline",
         "params": {"slots": 8, "pool": 512}, "limits": {"lengths_gap": 5e-5}}))
    cell = spec.cell("mnist-offline-s8", root=tmp_path,
                     bench_dir=tmp_path / "capbench")
    assert cell.params["slots"] == 8 and cell.mix["arrivals"] == "backlog"
    assert [m["name"] for m in cell.end_to_end] == ["setup_s"]
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")


@pytest.mark.parametrize("entry", spec.benchmark()["workloads"],
                         ids=lambda w: w["name"])
def test_every_cell_has_its_files(entry):
    cell = spec.cell(entry["name"])
    assert spec.driver(cell.mix["driver"]) is not None
    assert [m["name"] for m in cell.end_to_end][-1] == "setup_s"
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.reader(m["name"]))


@pytest.mark.parametrize("metric", spec.benchmark()["per_layer"],
                         ids=lambda m: m["name"])
def test_a_reader_with_nothing_to_read_returns_nothing(metric):
    empty = dict(window={}, trace={"busy_s": 0.0, "window_s": 0.0},
                 cell={}, cfg={})
    assert spec.reader(metric["name"])(empty) is None


def test_readers_on_a_window():
    rec = dict(window=dict(ticks=100, occupancy=0.5, flops=1.34e12,
                           bound_s=0.1, latency_p50_ms=4.0,
                           latency_p99_ms=9.0),
               trace=dict(busy_s=0.5, window_s=2.0), cell={}, cfg={})
    read = {m["name"]: spec.reader(m["name"])(rec)
            for m in spec.benchmark()["per_layer"]}
    assert read["forward_device_ms.offline"] == pytest.approx(5.0)
    assert read["mfu.offline"] == pytest.approx(1.0)
    assert read["roofline.offline"] == pytest.approx(20.0)
    assert read["device_idle_share.offline"] == pytest.approx(75.0)
    assert read["occupancy.server"] == pytest.approx(50.0)
    assert read["latency_p50_ms.server"] == 4.0
    assert read["latency_p99_ms.server"] == 9.0


def test_bursts_keep_the_arrivals_and_move_them_into_the_on_phase():
    burst = {"period_ms": 1000, "on_ms": 200, "on_factor": 3.0}
    a = serve.arrival_offsets(6000.0, 10.0, 3_000_000_077, burst)
    assert np.array_equal(
        a, serve.arrival_offsets(6000.0, 10.0, 3_000_000_077, burst))
    assert len(a) == 60_000 and np.all(np.diff(a) >= 0)
    assert 0 <= a[0] and a[-1] < 10.0
    # 3x the mean for a fifth of each second: three fifths of arrivals.
    assert abs(np.mean(np.mod(a, 1.0) < 0.2) - 0.6) < 0.01


def test_a_burst_that_cannot_keep_the_mean_is_refused():
    with pytest.raises(ValueError):
        serve.burst_time(np.array([0.5]), 1.0, {"period_ms": 1000,
                                                "on_ms": 500,
                                                "on_factor": 3.0})


@pytest.mark.parametrize("plan", ["engine", "per_op", "degraded"])
def test_a_cell_may_choose_its_plan(plan):
    import time

    import torch

    from capbench import harness, inputs
    cell = helpers.smoke_cell("mnist-offline")
    cell.params = dict(cell.params, plan=plan, smem_fraction=0.25)
    cfg = inputs.smoke(cell.config)
    chosen = serve.serving_plan(inputs.program_config(cfg), cell.params)
    assert (chosen is None) == (plan == "engine")
    if plan == "per_op":
        assert not chosen.pipelined
    out = harness.run_cell(cell, 31, helpers.WINDOW_S, False,
                           device=torch.device("cpu"),
                           t0=time.perf_counter(), cfg=cfg)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
