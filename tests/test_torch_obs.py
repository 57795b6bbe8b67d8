"""The port's spans and samples (``repro_torch.obs``) on the CPU: nothing
without a profiler session; under one, the engine's tick, the plan's ops
and the SGD step, nested as documented and on the profiler's own events."""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import capsnet_mnist
from repro_torch.core import capsnet, execplan
from repro_torch.serve.capsule import CapsRequest, CapsuleEngine

CFG = capsnet_mnist.smoke_config()
TICK = ["engine.sweep", "engine.admit", "engine.upload", "engine.dispatch",
        "engine.readback", "engine.finish"]
TRAIN = ["train.forward", "train.backward", "train.update"]


@pytest.fixture(autouse=True)
def clean():
    obs.reset()
    yield
    obs.reset()


@pytest.fixture(scope="module")
def params():
    return capsnet.init_params(torch.Generator().manual_seed(0), CFG,
                               device="cpu")


def _images(n, seed=0):
    return np.random.default_rng(seed).random(
        (n, CFG.image_hw, CFG.image_hw, CFG.in_channels), np.float32)


def _serve(params, n=10, **kw):
    engine = CapsuleEngine(params, CFG, device="cpu", **kw)
    for i, img in enumerate(_images(n)):
        engine.submit(CapsRequest(rid=i, image=img))
    engine.run()
    return engine


def _sgd(params):
    plan = execplan.compile_plan(CFG, batch=4, train=True, pipeline=True)
    p = {k: v.clone() for k, v in params.items()}
    x = torch.as_tensor(_images(4, seed=1))
    y = torch.arange(4) % CFG.num_classes
    capsnet.train_step(p, x, y, CFG, 1e-3, backend="kernels", plan=plan,
                       device="cpu")


def _children(spans, parent):
    return sorted((s for s in spans if s.parent == parent.id),
                  key=lambda s: s.start_ns)


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, obs.snapshot(), prof


def test_without_a_session_nothing_is_entered_or_kept(params, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no session")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    engine = _serve(params, slots=4)
    _sgd(params)
    assert engine.stats()["ok"] == 10
    assert obs.snapshot() == obs.Snapshot([], {})


def test_without_a_session_a_span_is_one_shared_no_op():
    assert not obs.recording()
    assert obs.span("engine.step") is obs.span("plan.", "Conv1")
    obs.sample("engine.queue_wait_s", 1.0)
    assert obs.snapshot().samples == {}


def test_every_tick_holds_its_phases_in_order(params):
    _, snap, _ = _traced(lambda: _serve(params, slots=4))
    steps = [s for s in snap.spans if s.name == "engine.step"]
    assert len(steps) == 3 and all(s.parent is None for s in steps)
    for step in steps:
        kids = _children(snap.spans, step)
        assert [k.name for k in kids] == TICK
        dispatch = kids[TICK.index("engine.dispatch")]
        inner = [s.name for s in _children(snap.spans, dispatch)]
        assert inner == ["plan.Conv1", "plan." + execplan.PIPE_NAME,
                         "model.decode"]
        for k in kids:
            assert step.start_ns <= k.start_ns <= k.end_ns <= step.end_ns


def test_the_profiler_records_the_same_spans(params):
    _, snap, prof = _traced(lambda: _serve(params, slots=4))
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith(("engine.", "plan.", "model."))]
    assert sorted(e.name() for e in events) == sorted(
        s.name for s in snap.spans)
    steps = sorted((e for e in events if e.name() == "engine.step"),
                   key=lambda e: e.start_ns())
    mine = sorted((s for s in snap.spans if s.name == "engine.step"),
                  key=lambda s: s.start_ns)
    for e, s in zip(steps, mine):          # the same clock: ours inside
        assert e.start_ns() <= s.start_ns <= s.end_ns <= e.end_ns()


def test_queue_wait_has_a_sample_per_admitted_request(params):
    engine, snap, _ = _traced(lambda: _serve(params, n=10, slots=4))
    waits = snap.samples["engine.queue_wait_s"]
    assert len(waits) == 10 == engine.stats()["ok"]
    assert all(w >= 0 for w in waits)
    assert sorted(waits)[-1] > sorted(waits)[0]  # later ticks waited longer


def test_a_training_step_holds_forward_backward_update(params):
    _, snap, _ = _traced(lambda: _sgd(params))
    step, = [s for s in snap.spans if s.name == "train.step"]
    assert [k.name for k in _children(snap.spans, step)] == TRAIN
    fwd = _children(snap.spans, step)[0]
    names = [s.name for s in snap.spans if s.parent == fwd.id]
    assert "plan.Conv1" in names and "model.decode" in names


def test_self_time_is_the_duration_less_the_children(params):
    _, snap, _ = _traced(lambda: _serve(params, slots=4))
    own = obs.self_ns(snap.spans)
    for s in snap.spans:
        kids = sum(k.end_ns - k.start_ns for k in snap.spans
                   if k.parent == s.id)
        assert own[s.id] == s.end_ns - s.start_ns - kids
        assert own[s.id] >= 0


def test_sharded_readback_follows_every_launch(params):
    engine, snap, _ = _traced(lambda: _serve(params, n=8, slots=4,
                                             n_shards=2))
    assert engine.stats()["ok"] == 8
    for step in (s for s in snap.spans if s.name == "engine.step"):
        kids = {k.name: k for k in _children(snap.spans, step)}
        plans = [s for s in snap.spans
                 if s.parent == kids["engine.dispatch"].id
                 and s.name == "plan.Conv1"]
        assert len(plans) == 2                # both shards launched first
        assert max(p.end_ns for p in plans) <= kids[
            "engine.readback"].start_ns


def test_served_lengths_are_the_forwards_bits(params):
    imgs = _images(4)
    engine = _serve(params, n=4, slots=4)
    want = capsnet.forward(params, imgs, CFG, backend="kernels",
                           plan=engine.plan, device="cpu")["lengths"]
    got = np.stack([r.lengths for r in sorted(engine.finished,
                                              key=lambda r: r.rid)])
    np.testing.assert_array_equal(got, want.numpy())


def test_only_the_profiling_thread_records(params):
    seen = []
    with profile(activities=[ProfilerActivity.CPU]):
        t = threading.Thread(target=lambda: seen.append(obs.recording()))
        t.start()
        t.join(timeout=30)
        with obs.span("outer"):
            with obs.span("inner"):
                pass
    assert not t.is_alive() and seen == [False]
    inner, outer = obs.snapshot().spans
    assert (inner.name, outer.name) == ("inner", "outer")
    assert inner.parent == outer.id and outer.parent is None
