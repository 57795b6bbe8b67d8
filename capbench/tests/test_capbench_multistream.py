"""The MultiStream cell (``mnist-multistream``) on the CPU: queries of the
mix's size, one outstanding at a time, each timed whole; its control and
an altered answer come out not correct, the program does not."""

import torch

from capbench import faults, harness, inputs, spec, trace
from capbench.drivers import serve
from capbench.tests import helpers

CELL = "mnist-multistream"


def test_the_mix_is_mlperf_multistream():
    cell = spec.cell(CELL)
    assert cell.mix["arrivals"] == "closed"
    assert cell.mix["samples_per_query"] == 8      # MLPerf's, rules 2.0+
    assert cell.params["slots"] == 8
    assert [m["name"] for m in cell.end_to_end] == ["query_p99_ms",
                                                    "setup_s"]


def driver_at_smoke_sizes(seed: int = 9) -> serve.Driver:
    cell = helpers.smoke_cell(CELL)
    cfg = inputs.smoke(cell.config)
    dev = torch.device("cpu")
    fam = spec.family_of(cfg)
    ctx = harness.Ctx(cfg=cfg, pcfg=fam.program_config(cfg), mix=cell.mix,
                      params=cell.params, limits=cell.limits, device=dev,
                      seed=seed, weights=fam.weights(cfg, seed, dev),
                      pool=fam.pool(cfg, cell.params, seed, dev))
    return serve.Driver(ctx)


def test_one_query_of_eight_is_outstanding_at_a_time():
    driver = driver_at_smoke_sizes()
    eng = driver.engine
    submitted = []
    submit = eng.submit

    def counted(req):
        # A request of a new query finds the engine holding only its own
        # query's requests: none in a slot, the rest of its query queued.
        assert not any(a is not None for a in eng.active)
        submitted.append(len(eng.queue))
        return submit(req)
    eng.submit = counted
    rec = driver.window(0.05, trace.no_span)
    n = len(submitted) // 8
    assert n == rec["queries"] >= 1 and len(submitted) == 8 * n
    assert submitted == list(range(8)) * n
    assert rec["images"] == 8 * n and rec["ticks"] == n
    assert 0 < rec["query_p50_ms"] <= rec["query_p99_ms"] \
        <= rec["query_max_ms"] <= 1e3 * rec["wall_s"]
    assert driver.end_to_end(rec)["query_p99_ms"] == rec["query_p99_ms"]
    attempted, failed = driver.counts()
    assert failed == 0 and attempted == 8 * n


def test_the_run_reports_its_end_to_end_metrics():
    out = helpers.run_smoke(CELL, seed=3_000_000_019)
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"query_p99_ms", "setup_s"}
    assert out["metrics"]["query_p99_ms"]["value"] > 0


def test_the_control_fails_and_the_program_passes():
    out = helpers.run_smoke(CELL, control=True)
    control = out["control_checks"]
    assert any(c["value"] > c["limit"] for c in control.values())
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())
    assert out["failed"] == 0


def test_an_altered_answer_is_not_correct():
    with faults.altered_answer():
        out = helpers.run_smoke(CELL)
    assert out["correct"] is False
    assert out["checks"]["lengths_gap"]["value"] > 1e-4
