"""The port's CapsuleEngine on the CPU at smoke_config: slot-batched
results equal the direct forward, and every request ends in exactly one
terminal status (ok / timeout / error / shed)."""

import numpy as np
import pytest
import torch

from repro_torch.configs import capsnet_mnist
from repro_torch.core import capsnet
from repro_torch.serve.capsule import (TERMINAL_STATUSES, CapsRequest,
                                       CapsuleEngine, EngineStalled)

CFG = capsnet_mnist.smoke_config()


@pytest.fixture(scope="module")
def params():
    return capsnet.init_params(torch.Generator().manual_seed(0), CFG,
                               device="cpu")


def _images(n, seed=0):
    return np.random.default_rng(seed).random(
        (n, CFG.image_hw, CFG.image_hw, CFG.in_channels), np.float32)


def _engine(params, **kw):
    return CapsuleEngine(params, CFG, device="cpu", **kw)


def _terminal_once(engine, n):
    st = engine.stats()
    assert st["submitted"] == n
    assert sum(st[s] for s in TERMINAL_STATUSES) == n
    assert len({id(r) for r in engine.finished}) == len(engine.finished) == n
    assert all(r.status in TERMINAL_STATUSES for r in engine.finished)


@pytest.mark.parametrize("backend", ["kernels", "torch"])
def test_engine_matches_direct_forward(params, backend):
    imgs = _images(7)
    engine = _engine(params, slots=3, backend=backend)
    for i, img in enumerate(imgs):
        engine.submit(CapsRequest(rid=i, image=img))
    done = engine.run()
    want = capsnet.forward(params, imgs, CFG, backend="torch",
                           device="cpu")["lengths"].numpy()
    assert engine.ticks == 3            # 7 requests through 3 slots
    for r in done:
        assert r.status == "ok"
        np.testing.assert_allclose(r.lengths, want[r.rid], rtol=1e-5,
                                   atol=1e-5)
        assert r.pred == int(np.argmax(want[r.rid]))
    _terminal_once(engine, 7)
    st = engine.stats()
    assert st["ok"] == 7 and st["requests_per_s"] > 0
    assert st["mean_latency_ms"] > 0 and 0 < st["occupancy"] <= 1


def test_engine_compiles_one_pipelined_plan(params):
    engine = _engine(params, slots=4)
    assert engine.plan.batch == 4 and engine.plan.pipelined
    assert _engine(params, slots=4, backend="torch").plan is None


def test_freed_slot_returns_to_zeros(params):
    engine = _engine(params, slots=2)
    engine.submit(CapsRequest(rid=0, image=_images(1)[0]))
    engine.step()
    assert engine.active == [None, None]
    engine.submit(CapsRequest(rid=1, image=_images(1, seed=3)[0]))
    engine.step()
    assert torch.count_nonzero(engine._batch_dev[1]) == 0


def test_non_finite_row_ends_in_error(params):
    imgs = _images(2)
    imgs[1, 3, 3, 0] = np.nan
    engine = _engine(params, slots=2)
    for i, img in enumerate(imgs):
        engine.submit(CapsRequest(rid=i, image=img))
    done = {r.rid: r for r in engine.run()}
    assert done[0].status == "ok" and done[1].status == "error"
    _terminal_once(engine, 2)


@pytest.mark.parametrize("admission,shed_rids", [("reject", {2, 3}),
                                                 ("shed-oldest", {0, 1})])
def test_bounded_queue_sheds(params, admission, shed_rids):
    engine = _engine(params, slots=1, max_queue=2, admission=admission)
    for i, img in enumerate(_images(4)):
        engine.submit(CapsRequest(rid=i, image=img))
    engine.run()
    assert {r.rid for r in engine.finished if r.status == "shed"} == shed_rids
    assert engine.stats()["ok"] == 2
    _terminal_once(engine, 4)


def test_deadline_expires_under_an_injected_clock(params):
    now = [0.0]
    engine = _engine(params, slots=1)
    engine._now = lambda: now[0]
    imgs = _images(3)
    engine.submit(CapsRequest(rid=0, image=imgs[0]))
    engine.submit(CapsRequest(rid=1, image=imgs[1], deadline_s=1.0))
    engine.submit(CapsRequest(rid=2, image=imgs[2], deadline_s=10.0))
    now[0] = 2.0                       # rid 1 expires while queued
    engine.run()
    status = {r.rid: r.status for r in engine.finished}
    assert status == {0: "ok", 1: "timeout", 2: "ok"}
    _terminal_once(engine, 3)


def test_run_raises_engine_stalled(params):
    engine = _engine(params, slots=1, stall_ticks=3)
    engine.submit(CapsRequest(rid=0, image=_images(1)[0]))
    engine.step = lambda: 0            # a tick that never finishes anything
    with pytest.raises(EngineStalled, match="3 consecutive ticks"):
        engine.run()
    engine = _engine(params, slots=1)
    for i, img in enumerate(_images(3)):
        engine.submit(CapsRequest(rid=i, image=img))
    with pytest.raises(EngineStalled, match="max_ticks=2"):
        engine.run(max_ticks=2)


def test_engine_rejects_bad_input(params):
    with pytest.raises(ValueError, match="admission"):
        _engine(params, admission="lifo")
    engine = _engine(params, slots=1)
    with pytest.raises(ValueError, match="does not match"):
        engine.submit(CapsRequest(rid=0, image=np.zeros(
            (CFG.in_channels, CFG.image_hw, CFG.image_hw), np.float32)))
    assert engine.step() == 0 and engine.ticks == 0
