"""The port's degraded planning (``execplan.degrade_plan``) for Hopper.

The ladder is ``compile_plan``'s own, walked under a shared-memory budget
cut to a share of ``planner.SMEM_BYTES``: the pipelined pair dissolves,
routing layers go resident -> streamed -> streamed-global over the
cluster sizes, GEMM tiles shrink.  The concessions are pinned per arch
at the engine's batch, as ``tests/test_degrade_golden.py`` pins the
reference's.  The port has no batch rung: no footprint grows with the
batch, so a smaller batch never makes a plan fit.  A degraded plan
changes the schedule, never the math: its forward on the smoke config
equals the reference's ``forward(backend="jnp")`` at the reference's
tolerance for degraded plans (tests/test_faults.py, 1e-4).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import registry as ref_registry
from repro.core import capsnet as R
from repro_torch.configs import capsnet_mnist, registry
from repro_torch.convert import params_from_numpy
from repro_torch.core import capsnet, execplan
from repro_torch.core.execplan import (PIPE_NAME, PlanError, compile_plan,
                                       degrade_plan)
from repro_torch.core.planner import SMEM_BYTES

BATCH = 8                        # the engine's slots on the card
DISSOLVE = (f"pipelined {PIPE_NAME} pair -> per-op (inter-layer u "
            f"round-trips device memory again)")
GEMM_SHRINK = ("Conv1: conv tiles (128,16,128) -> (64,16,64)",
               "PrimaryCaps: conv tiles (128,16,128) -> (64,16,64)")

# (arch, budget share) -> the exact concessions at batch 8.
GOLDEN = {
    ("capsnet-mnist", 1.0): (),
    ("capsnet-mnist", 0.5): (),
    ("capsnet-mnist", 0.25): (DISSOLVE,),
    ("capsnet-mnist", 0.125): (DISSOLVE,) + GEMM_SHRINK + (
        "ClassCaps-Routing: resident -> streamed",
        "ClassCaps-Routing: block_i 72 -> 16"),
    ("capsnet-svhn", 1.0): (),
    ("capsnet-svhn", 0.5): (
        "PrimaryCaps-Routing: block_i 64 -> 16",
        "PrimaryCaps-Routing: cluster 8 -> 16"),
    ("capsnet-svhn", 0.25): (
        DISSOLVE,
        "ClassCaps-Routing[0]: block_i 64 -> 4",
        "ClassCaps-Routing[0]: cluster 8 -> 16"),
    ("capsnet-svhn", 0.125): (DISSOLVE,) + GEMM_SHRINK + (
        "ClassCaps-Routing[0]: streamed -> streamed-global",
        "ClassCaps-Routing[0]: block_i 64 -> 4",
        "ClassCaps-Routing[0]: cluster 8 -> 16"),
    ("capsnet-cifar10", 1.0): (),
}

# (arch, budget share) -> the op the named PlanError blames.
EXHAUSTED = {
    ("capsnet-mnist", 0.0625): "Conv1",
    ("capsnet-svhn", 0.0625): "Conv1",
    ("capsnet-cifar10", 0.0625): "Conv1",
    ("capsnet-cifar10", 0.5): "ClassCaps-Routing[0]",
    ("capsnet-cifar10", 0.25): "ClassCaps-Routing[0]",
    ("capsnet-cifar10", 0.125): "ClassCaps-Routing[0]",
}
LADDER = (1.0, 0.5, 0.25, 0.125, 0.0625)


@pytest.mark.parametrize("arch", registry.CAPSNET_ARCHS)
@pytest.mark.parametrize("pipeline", [True, False])
def test_full_budget_is_the_memoized_plan(arch, pipeline):
    cfg = registry.get_config(arch)
    plan, rep = degrade_plan(cfg, SMEM_BYTES, batch=BATCH, pipeline=pipeline)
    assert plan is compile_plan(cfg, batch=BATCH, pipeline=pipeline)
    assert rep.concessions == () and not rep.degraded
    assert rep.batch == rep.requested_batch == BATCH
    assert rep.smem_budget == SMEM_BYTES


@pytest.mark.parametrize(("arch", "share"), sorted(GOLDEN),
                         ids=lambda v: str(v))
def test_concession_sequence_golden(arch, share):
    cfg = registry.get_config(arch)
    budget = int(SMEM_BYTES * share)
    plan, rep = degrade_plan(cfg, budget, batch=BATCH, pipeline=True)
    assert rep.concessions == GOLDEN[(arch, share)]
    assert rep.degraded == bool(rep.concessions)
    assert plan.batch == rep.batch == BATCH and plan.smem_budget == budget
    assert all(op.smem_bytes <= budget for op in plan.ops)
    assert plan.pipelined == (DISSOLVE not in rep.concessions
                              and compile_plan(cfg, batch=BATCH,
                                               pipeline=True).pipelined)


def test_mnist_ladder_runs_k3_then_k4():
    """The replans the engine serves on the card: K5 at 0.5, K3 (the
    per-op ClassCaps resident) at 0.25, K4 (streamed) at 0.125."""
    cfg = capsnet_mnist.config()
    kinds = {}
    for share in (0.5, 0.25, 0.125):
        plan, _ = degrade_plan(cfg, int(SMEM_BYTES * share), batch=BATCH,
                               pipeline=True)
        kinds[share] = [(op.kernel, op.mode) for op in plan.ops]
    assert kinds[0.5] == [("conv_im2col", None),
                          ("primary_routing", "resident")]
    assert kinds[0.25] == [("conv_im2col", None),
                           ("conv_im2col+squash", None),
                           ("votes_routing", "resident")]
    assert kinds[0.125] == [("conv_im2col", None),
                            ("conv_im2col+squash", None),
                            ("votes_routing", "streamed")]


@pytest.mark.parametrize(("arch", "share"), sorted(EXHAUSTED),
                         ids=lambda v: str(v))
def test_exhausted_ladder_raises_named_planerror(arch, share):
    budget = int(SMEM_BYTES * share)
    with pytest.raises(PlanError) as err:
        degrade_plan(registry.get_config(arch), budget, batch=BATCH,
                     pipeline=True)
    msg = str(err.value)
    assert f"degraded {budget} B shared-memory budget" in msg
    assert f"{EXHAUSTED[(arch, share)]}:" in msg


def test_report_keeps_the_requested_batch():
    """No batch rung: the degraded plan and its report keep the batch
    asked for, at every budget of the MNIST ladder that fits."""
    cfg = capsnet_mnist.config()
    for share in LADDER[:-1]:
        for batch in (1, BATCH, 17):
            plan, report = degrade_plan(cfg, int(SMEM_BYTES * share),
                                        batch=batch, pipeline=True)
            assert plan.batch == report.batch == report.requested_batch \
                == batch, (share, batch)


@pytest.mark.parametrize("arch", registry.CAPSNET_ARCHS)
def test_no_footprint_grows_with_the_batch(arch):
    """Why there is no batch rung: at every budget of the ladder a plan
    exists at every batch from 1 to 64 or at none, and each routing
    schedule's footprint at a given cluster size is the same at every
    batch."""
    cfg = registry.get_config(arch)
    for share in LADDER:
        budget = int(SMEM_BYTES * share)
        fits = set()
        for batch in (1, 2, 3, 8, 17, 64):
            try:
                compile_plan(cfg, batch=batch, smem_budget=budget,
                             pipeline=True)
                fits.add(True)
            except PlanError:
                fits.add(False)
        assert len(fits) == 1, (arch, share)
        for lay in cfg.routing_stack():
            for cs in execplan.CLUSTER_SIZES:
                scheds = {
                    batch: execplan.plan_votes_routing_cluster(
                        lay.in_caps, lay.in_dim, lay.jd, lay.num_caps,
                        iters=lay.iters, batch=batch, smem_budget=budget,
                        cluster=cs)
                    for batch in (1, 8, 64)}
                shapes = {None if s is None else
                          (s.mode, s.block_i, s.smem_bytes)
                          for s in scheds.values()}
                assert len(shapes) == 1, (arch, share, lay.name, cs)


def test_degraded_summary_rows():
    cfg = capsnet_mnist.config()
    full = compile_plan(cfg, batch=BATCH, pipeline=True)
    low, _ = degrade_plan(cfg, SMEM_BYTES // 8, batch=BATCH, pipeline=True)
    assert [r["name"] for r in full.summary()] == ["Conv1", PIPE_NAME]
    rows = low.summary()
    assert [r["name"] for r in rows] == [
        "Conv1", "PrimaryCaps", "ClassCaps-Routing"]
    assert rows[-1]["mode"] == "streamed"
    assert rows[-1]["smem_kib"] == low.ops[-1].smem_bytes / 1024


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's params, two seeded images and its jnp lengths on
    ``arch``'s smoke config."""
    cfg_r = ref_registry.get_smoke_config(arch)
    params_r = R.init_params(jax.random.PRNGKey(0), cfg_r)
    images = np.random.default_rng(0).random(
        (2, cfg_r.image_hw, cfg_r.image_hw, cfg_r.in_channels), np.float32)
    want = np.asarray(R.forward(params_r, jnp.asarray(images), cfg_r,
                                backend="jnp")["lengths"])
    return params_r, images, want


@pytest.mark.parametrize(("arch", "share"), [("capsnet-mnist", 0.125),
                                           ("capsnet-svhn", 0.25),
                                           ("capsnet-svhn", 0.125)],
                         ids=lambda v: str(v))
def test_degraded_plan_output_parity(arch, share):
    """A smoke config's degraded plan (per-op, and at 1/8 smaller GEMM
    tiles) on the kernels backend equals the reference's jnp forward."""
    params_r, images, want = _reference(arch)
    cfg = registry.get_smoke_config(arch)
    plan, rep = degrade_plan(cfg, int(SMEM_BYTES * share), batch=2,
                             pipeline=True)
    assert rep.degraded and not plan.pipelined
    params = params_from_numpy({k: np.asarray(v)
                                for k, v in params_r.items()}, "cpu")
    got = capsnet.forward(params, images, cfg, backend="kernels", plan=plan,
                          device="cpu")["lengths"].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
