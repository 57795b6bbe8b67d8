"""The port's hardened CapsuleEngine against the reference's, on the CPU.

Each scenario drives both engines through the same ``FaultSpec`` schedule
(and the same injected clock where deadlines matter) over the config and
seeded images of ``tests/test_faults.py``, with the reference's
parameters converted to the port.  The reference engine serves on its
``jnp`` backend (``pallas`` where the breaker must trip: the plain path
has nothing to trip from), the port's on ``kernels``, whose wrappers run
their plain twins on the CPU.  Both must end every request in the same
status after the same retries, keep the same counters and build their
forward as often, and give lengths equal to 1e-5 (the reference's engine
tolerance).  ``vmem_shrink`` has port-only cases, since the two budgets
differ by design (shared memory of one CTA, not VMEM), as has the asyncio
server.  ``check_engine_stats`` holds every port run.
"""

import asyncio

import jax
import numpy as np
import pytest

from repro.core import capsnet as R
from repro.core import faults as ref_faults
from repro.serve import CapsRequest as RefRequest
from repro.serve import CapsuleEngine as RefEngine
from repro.serve import capsule as ref_capsule
from repro.verify import invariants as ref_invariants
from repro_torch.convert import params_from_numpy
from repro_torch.core import capsnet, execplan, faults
from repro_torch.core.execplan import PlanError
from repro_torch.serve import capsule
from repro_torch.serve.capsule import (AsyncCapsuleServer, CapsRequest,
                                       CapsuleEngine, EngineStalled)
from repro_torch.verify import (assert_engine_stats, check_engine_stats,
                                invariants)

KEY = jax.random.PRNGKey(0)
FIELDS = dict(image_hw=14, conv1_channels=16, conv1_kernel=5, pc_kernel=3,
              num_primary_groups=4, primary_dim=4, class_dim=8,
              use_decoder=False)
REF_CFG = R.CapsNetConfig(**FIELDS)
CFG = capsnet.CapsNetConfig(**FIELDS)
REF_PARAMS = R.init_params(KEY, REF_CFG)
PARAMS = params_from_numpy({k: np.asarray(v) for k, v in REF_PARAMS.items()},
                           "cpu")
IMAGES = np.asarray(jax.random.uniform(
    KEY, (6, CFG.image_hw, CFG.image_hw, 1)))
COUNTERS = ("ok", "timeout", "error", "shed", "submitted", "retries",
            "replans", "breaker_trips", "forward_failures", "poisoned",
            "unquarantined", "quarantined", "degraded", "ticks", "n_shards",
            "slots_per_shard", "per_shard", "queue_bucket")


def _spec(site, kind, **kw):
    return dict(site=site, kind=kind, **kw)


FWD, TICK = "engine.forward", "engine.tick"
# name -> engine options, phases of (rids submitted, fault specs),
# deadlines by rid, the clock each dispatch costs, whether run() stalls,
# and the reference's backend.
SCENARIOS = {
    "nan_storm": dict(
        kw=dict(slots=2),
        phases=[(range(5), [_spec(FWD, "nan_output", at=0, times=2)])]),
    "inf_past_max_retries": dict(
        kw=dict(slots=1, max_retries=1, quarantine_after=10),
        phases=[(range(1), [_spec(FWD, "inf_output", at=0, times=50)])]),
    "quarantine_sheds_backlog": dict(
        kw=dict(slots=1, max_retries=5, quarantine_after=2),
        phases=[(range(3), [_spec(FWD, "nan_output", at=0, times=100)])]),
    "probation_lifts_quarantine": dict(
        kw=dict(slots=2, max_retries=5, retry_backoff_ticks=0,
                quarantine_after=2, probation_ticks=3),
        phases=[(range(1), [_spec(FWD, "nan_output", at=0, times=2)]),
                (range(1, 5), [])]),
    "slot_corrupt_healed": dict(
        kw=dict(slots=2),
        phases=[(range(4), [_spec(TICK, "slot_corrupt", at=0, times=1,
                                  seed=7),
                            _spec(TICK, "slot_corrupt", at=1, times=1,
                                  seed=3)])]),
    "plan_error_storm_trips_breaker": dict(
        kw=dict(slots=2, breaker_after=2), ref_backend="pallas",
        phases=[(range(4), [_spec(FWD, "plan_error", at=0, times=2)])]),
    "retry_past_deadline_times_out": dict(
        kw=dict(slots=1, max_retries=5, retry_backoff_ticks=0,
                quarantine_after=10), deadlines={0: 1.0}, clock=0.6,
        phases=[(range(1), [_spec(FWD, "nan_output", at=0, times=2)])]),
    "stall_detected": dict(
        kw=dict(slots=1, stall_ticks=5), stalls=True,
        phases=[(range(1), [_spec(TICK, "stall", at=0, times=1000)])]),
    "bounded_queue_reject": dict(
        kw=dict(slots=1, max_queue=2, admission="reject"),
        phases=[(range(3), [])]),
    "bounded_queue_shed_oldest": dict(
        kw=dict(slots=1, max_queue=2, admission="shed-oldest"),
        phases=[(range(3), [])]),
}


def _drive(mod, engine_cls, request_cls, params, cfg, sc, **extra):
    engine = engine_cls(params, cfg, **sc["kw"], **extra)
    clock = {"t": 0.0}
    if "clock" in sc:
        engine._now = lambda: clock["t"]
        forward = engine._forward

        def slow_forward(*a):          # each dispatch costs sc["clock"] s
            out = forward(*a)
            clock["t"] += sc["clock"]
            return out

        engine._forward = slow_forward
    fired = []
    for rids, specs in sc["phases"]:
        for rid in rids:
            engine.submit(request_cls(rid=rid, image=IMAGES[rid],
                                      deadline_s=sc.get("deadlines",
                                                        {}).get(rid)))
        with mod.inject(*(mod.FaultSpec(**s) for s in specs)) as reg:
            if sc.get("stalls"):
                with pytest.raises(Exception, match="stalled"):
                    engine.run()
            else:
                engine.run()
            fired.append(list(reg.fired))
    return engine, fired


def _outcome(engine):
    return [(r.rid, r.status, r.retries) for r in engine.finished]


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_engine_matches_the_reference_engine(name):
    sc = SCENARIOS[name]
    ref, ref_fired = _drive(ref_faults, RefEngine, RefRequest, REF_PARAMS,
                            REF_CFG, sc,
                            backend=sc.get("ref_backend", "jnp"))
    port, port_fired = _drive(faults, CapsuleEngine, CapsRequest, PARAMS,
                              CFG, sc, backend="kernels", device="cpu")
    assert port_fired == ref_fired
    assert _outcome(port) == _outcome(ref)
    rs, ps = ref.stats(), port.stats()
    assert {k: ps[k] for k in COUNTERS} == {k: rs[k] for k in COUNTERS}
    assert port._forward_builds == ref._forward_traces
    # A stalled run still holds its request: both checkers say so alike.
    assert check_engine_stats(ps) == ref_invariants.check_engine_stats(rs)
    assert bool(check_engine_stats(ps)) == bool(sc.get("stalls"))
    for want, got in zip(ref.finished, port.finished):
        if want.lengths is None:
            assert got.lengths is None
            continue
        np.testing.assert_allclose(got.lengths, np.asarray(want.lengths),
                                   rtol=1e-5, atol=1e-5)
        assert got.pred == want.pred
    if not sc.get("stalls"):
        assert_engine_stats(port)


def test_terminal_statuses_pinned_to_the_reference():
    assert capsule.TERMINAL_STATUSES == ref_capsule.TERMINAL_STATUSES
    assert invariants.TERMINAL_STATUSES == ref_invariants.TERMINAL_STATUSES


def test_check_engine_stats_flags_broken_accounting():
    engine = _engine(slots=2)
    for i in range(3):
        engine.submit(CapsRequest(rid=i, image=IMAGES[i]))
    engine.run()
    s = engine.stats()
    assert check_engine_stats(s) == ref_invariants.check_engine_stats(s) \
        == []
    s["ok"] += 1
    s["per_shard"][0]["quarantined"] = 1
    assert check_engine_stats(s) == ref_invariants.check_engine_stats(s)
    assert len(check_engine_stats(s)) == 3


# -- port-only: the replan, the plan contract, the breaker -----------------

def _engine(**kw):
    return CapsuleEngine(PARAMS, CFG, device="cpu", **kw)


def _reference_lengths(rid):
    return np.asarray(R.forward(REF_PARAMS, IMAGES[rid][None],
                                REF_CFG)["lengths"][0])


def _shrink_run(factor, n=6, at=1, times=2, extra=(), **kw):
    engine = _engine(slots=2, **kw)
    for i in range(n):
        engine.submit(CapsRequest(rid=i, image=IMAGES[i]))
    assert engine._forward_builds == 0
    with faults.inject(faults.FaultSpec(site=TICK, kind="vmem_shrink",
                                        at=at, times=times, factor=factor),
                       *extra):
        engine.run()
    return engine, assert_engine_stats(engine)


def test_vmem_shrink_swaps_the_degraded_plan():
    """1/8 of the budget: the pair dissolves and the GEMM tiles shrink;
    one replan across the two-tick window, one new forward build."""
    engine, s = _shrink_run(0.125)
    assert s["ok"] == 6 and s["replans"] == 1 and s["breaker_trips"] == 0
    assert s["degraded"] and engine.degrade_report.degraded
    assert not engine.plan.pipelined
    assert engine.plan.smem_budget == engine.degrade_report.smem_budget \
        == s["smem_budget"] == execplan.SMEM_BYTES // 8
    assert engine._forward_builds == 2
    for r in engine.finished:
        np.testing.assert_allclose(r.lengths, _reference_lengths(r.rid),
                                   rtol=1e-4, atol=1e-4)


def test_vmem_shrink_noop_factor_keeps_the_plan():
    engine, s = _shrink_run(1.0, n=4, times=1)
    assert s["ok"] == 4 and s["replans"] == 0 and not s["degraded"]
    assert engine._forward_builds == 1
    assert s["smem_budget"] == engine._orig_budget == execplan.SMEM_BYTES


def test_vmem_shrink_infeasible_trips_the_breaker():
    engine, s = _shrink_run(0.0625, times=1)
    assert s["ok"] == 6
    assert s["breaker_trips"] == 1 and s["replans"] == 0
    assert s["degraded"] and engine.plan is None
    assert engine._backend == "torch" and engine.device.type == "cpu"
    assert engine._forward_builds == 2
    for r in engine.finished:
        np.testing.assert_allclose(r.lengths, _reference_lengths(r.rid),
                                   rtol=1e-4, atol=1e-4)


def test_plan_swap_clears_quarantine():
    engine, s = _shrink_run(
        0.125, n=4, times=1, quarantine_after=1, probation_ticks=None,
        extra=(faults.FaultSpec(site=FWD, kind="nan_output", at=0,
                                times=1),))
    assert s["error"] == 2            # quarantine_after=1: both slots, tick 0
    assert s["replans"] == 1 and s["unquarantined"] == 2
    assert engine.quarantined == set() and s["ok"] == 2
    assert engine._forward_builds == 2


def test_nan_storm_plus_half_budget():
    engine, s = _shrink_run(
        0.5, at=2, times=1,
        extra=(faults.FaultSpec(site=FWD, kind="nan_output", at=0,
                                times=2),))
    assert s["poisoned"] >= 1 and s["ok"] == 6
    assert s["smem_budget"] == engine._orig_budget // 2
    # Half the budget keeps every schedule: the plan is swapped for its
    # twin at the new budget, with nothing conceded.
    assert s["replans"] == 1 and not engine.degrade_report.degraded
    assert engine.plan.ops == execplan.compile_plan(
        CFG, batch=2, pipeline=True).ops


def test_breaker_trip_clears_quarantine():
    engine = _engine(slots=2)
    engine.quarantined = {0, 1}
    engine._poison_streak = [3, 3]
    engine._trip_breaker()
    assert engine.quarantined == set() and engine._poison_streak == [0, 0]
    assert engine.stats()["unquarantined"] == 2
    assert engine._backend == "torch" and engine.degraded


def test_plan_for_fewer_slots_is_refused():
    small = execplan.compile_plan(CFG, batch=2, pipeline=False)
    with pytest.raises(PlanError, match="batch 2 cannot serve 4 slots"):
        _engine(slots=4, plan=small)
    engine = _engine(slots=2, plan=small)
    assert engine.plan is small
    assert engine.stats()["smem_budget"] == small.smem_budget


def test_stats_report_one_shard_of_every_slot():
    engine = _engine(slots=3, max_queue=1)
    for rid in range(5):
        engine.submit(CapsRequest(rid=rid, image=IMAGES[rid]))
    engine.run()
    s = assert_engine_stats(engine)
    assert (s["n_shards"], s["slots_per_shard"]) == (1, 3)
    assert s["per_shard"][0]["ok"] == s["ok"] == 1
    assert s["queue_bucket"]["shed"] == s["shed"] == 4


def test_kernel_failure_propagates_past_the_breaker(monkeypatch):
    """Only a PlanError feeds the breaker: a kernel that does not build or
    launch raises out of step() instead of being served around."""
    from repro_torch.kernels import ops

    def refused(*args, **kwargs):
        raise RuntimeError("im2col_patches_f32: CUDA error 1 (refused)")

    engine = _engine(slots=2, breaker_after=1)
    engine.submit(CapsRequest(rid=0, image=IMAGES[0]))
    monkeypatch.setattr(ops, "conv2d", refused)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        engine.step()
    s = engine.stats()
    assert (s["forward_failures"], s["breaker_trips"]) == (0, 0)
    assert engine._backend == "kernels" and not engine.degraded


# -- AsyncCapsuleServer ------------------------------------------------------

def _serve(engine, submit):
    async def main():
        async with AsyncCapsuleServer(engine) as server:
            return await submit(server)
    return asyncio.run(main())


def test_async_server_serves_concurrent_submissions():
    engine = _engine(slots=3)
    reqs = _serve(engine, lambda server: asyncio.gather(
        *(server.submit(IMAGES[i]) for i in range(6))))
    assert all(r.status == "ok" for r in reqs)
    assert engine._forward_builds == 1
    for i, r in enumerate(reqs):
        np.testing.assert_allclose(r.lengths, _reference_lengths(i),
                                   rtol=1e-5, atol=1e-5)
    assert_engine_stats(engine)


def test_async_server_recycles_slots_continuously():
    engine = _engine(slots=2)

    async def waves(server):
        first = asyncio.ensure_future(asyncio.gather(
            *(server.submit(IMAGES[i]) for i in range(3))))
        await asyncio.sleep(0)               # let the first wave land
        second = asyncio.gather(
            *(server.submit(IMAGES[i]) for i in range(3, 6)))
        return await first + await second

    reqs = _serve(engine, waves)
    assert all(r.status == "ok" for r in reqs)
    assert len(engine.finished) == 6 and engine._forward_builds == 1


def test_async_server_admission_control_sheds():
    engine = _engine(slots=1, max_queue=2, admission="reject")
    reqs = _serve(engine, lambda server: asyncio.gather(
        *(server.submit(IMAGES[i % 6]) for i in range(8))))
    statuses = [r.status for r in reqs]
    assert set(statuses) <= {"ok", "shed"} and "shed" in statuses
    s = assert_engine_stats(engine)
    assert s["ok"] + s["shed"] == s["submitted"] == 8


def test_async_server_driver_failure_reaches_every_future():
    engine = _engine(slots=1)

    def broken_step():
        raise EngineStalled("the engine is stalled (injected)")

    engine.step = broken_step

    async def main():
        server = AsyncCapsuleServer(engine)
        futs = [asyncio.ensure_future(server.submit(IMAGES[i]))
                for i in range(3)]
        done = await asyncio.gather(*futs, return_exceptions=True)
        with pytest.raises(EngineStalled):
            await server.stop()
        return done

    done = asyncio.run(main())
    assert len(done) == 3
    assert all(isinstance(e, EngineStalled) for e in done)
