"""K4 (the streamed votes + routing forward, its logits on chip or in
device memory) and K14b (the split path's routing over a materialized
u_hat) on the cluster core, against the JAX reference on the CPU; and
their plans.

On the card each sample routes over a thread-block cluster of ``cs`` CTAs
(``csrc/votes_routing.cu``'s ``votes_routing_cluster_kernel`` with streamed
votes, ``csrc/routing.cu``'s ``routing_cluster_kernel``), on the pass loop
of ``csrc/routing_cluster.cuh``; on the CPU the twins follow the cluster's
order (``cluster_plain.replay``): each rank sums s over its own block of
rows, ``block_i`` rows at a time when they stream, and the ranks' partials
are added in rank order.  They are held to the reference's Pallas kernels
in interpret mode (``_vr_core`` / ``_vr_core_res`` in mode ``streamed``,
and ``routing``) at the MNIST and SVHN smoke configs' first routing layer
and at a ragged capsule count with a ragged i-tile, at the reference's
tolerances (rtol 1e-5 / atol 1e-6).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import routing as ref_routing
from repro.kernels import votes_routing as ref_vr
from repro_torch.configs import capsnet_cifar10, capsnet_mnist, capsnet_svhn
from repro_torch.core import execplan, planner
from repro_torch.core.execplan import (CLUSTER_SIZES, STREAMED_GLOBAL,
                                       PlanError, compile_plan)
from repro_torch.kernels import ops
from repro_torch.kernels import routing as k14b
from repro_torch.kernels import votes_routing as vr

TOL = dict(rtol=1e-5, atol=1e-6)
BATCH = 3


def _layer(cfg):
    lay = cfg.routing_stack()[0]
    return lay.in_caps, lay.in_dim, lay.num_caps, lay.caps_dim, lay.iters


# (I, C, J, D, iters, block_i): the smoke configs' first routing layer
# (MNIST's ClassCaps, SVHN's bottleneck) and a ragged I with a ragged tile.
SHAPES = {"mnist-smoke": _layer(capsnet_mnist.smoke_config()) + (12,),
          "svhn-smoke": _layer(capsnet_svhn.smoke_config()) + (16,),
          "ragged": (27, 4, 5, 8, 3, 5)}


def _rand(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _inputs(name, seed=0):
    i_dim, c, j, d, iters, bi = SHAPES[name]
    return (_rand(seed, BATCH, i_dim, c, scale=0.5),
            _rand(seed + 1, i_dim, j * d, c, scale=0.3),
            _rand(seed + 2, BATCH, j * d, scale=0.1), j, iters, bi)


@functools.lru_cache(maxsize=None)
def _reference(name: str, residual: bool) -> np.ndarray:
    """The reference's streamed kernel (interpret mode) on ``name``'s
    inputs, with the residual epilogue when ``residual``."""
    u, w, r, j, iters, bi = _inputs(name)
    st = ref_vr._VRStatics(iters=iters, num_classes=j, mode="streamed",
                           block_i=bi, bwd_mode="streamed", bwd_block_i=bi,
                           interpret=True)
    if residual:
        return np.asarray(ref_vr._vr_core_res(st, *map(jnp.asarray,
                                                       (u, w, r))))
    return np.asarray(ref_vr._vr_core(st, jnp.asarray(u), jnp.asarray(w)))


@pytest.mark.parametrize("mode,residual", [("streamed", False),
                                           (STREAMED_GLOBAL, True)],
                         ids=["streamed", "global+r"])
@pytest.mark.parametrize("cs", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_k4_cluster_twin_matches_reference(name, cs, mode, residual):
    """K4's twin on a cs-CTA cluster, its votes streamed ``block_i`` rows
    at a time (the logits on chip, or in device memory: the same
    arithmetic), against the reference's streamed kernel; the wrapper on
    CPU tensors is the twin, bit for bit."""
    u, w, r, j, iters, bi = _inputs(name)
    t = torch.from_numpy
    rr = t(r) if residual else None
    kw = dict(iters=iters, num_classes=j, mode=mode, block_i=bi)
    twin = vr.cluster_routing_plain(t(u), t(w), cluster=cs, r=rr, **kw)
    np.testing.assert_allclose(twin.numpy(), _reference(name, residual),
                               **TOL)
    got = vr.votes_routing(t(u), t(w), r=rr, cluster=cs, **kw)
    torch.testing.assert_close(got, twin, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["resident", "streamed"])
@pytest.mark.parametrize("cs", [1, 2, 4])
def test_k14b_cluster_twin_matches_reference(cs, mode):
    """K14b's twin on a cs-CTA cluster (each CTA's rows of u_hat resident,
    or streamed in ragged tiles of 7 rows over 50 capsules: ranks of 50,
    25 and 13 rows) against the reference's split routing kernel."""
    uh = _rand(20, BATCH, 50, 10 * 8, scale=0.3)
    want = ref_routing.routing(jnp.asarray(uh), iters=3, num_classes=10,
                               interpret=True)
    kw = dict(iters=3, num_classes=10, mode=mode, block_i=7, cluster=cs)
    got = k14b.routing(torch.from_numpy(uh), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    torch.testing.assert_close(
        got, k14b.routing_plain(torch.from_numpy(uh), **kw), rtol=0, atol=0)


def test_k4_placements_share_one_order_and_cs1_is_one_ctas():
    """Every placement of the logits gives the same bits on the CPU twin,
    and one rank reproduces one CTA's fused passes (the split routing's
    order over the same votes)."""
    u, w, r, j, iters, bi = _inputs("ragged", seed=30)
    t = torch.from_numpy
    kw = dict(iters=iters, num_classes=j, block_i=bi)
    for cs in (1, 4):
        torch.testing.assert_close(
            vr.cluster_routing_plain(t(u), t(w), mode="streamed",
                                     cluster=cs, **kw),
            vr.cluster_routing_plain(t(u), t(w), mode=STREAMED_GLOBAL,
                                     cluster=cs, **kw), rtol=0, atol=0)
    votes = torch.einsum("bic,inc->bin", t(u), t(w))
    torch.testing.assert_close(
        vr.cluster_routing_plain(t(u), t(w), mode="streamed", cluster=1,
                                 **kw),
        vr.votes_routing_plain(t(u), t(w), mode="streamed", **kw),
        rtol=0, atol=0)
    torch.testing.assert_close(
        k14b.routing_plain(votes, mode="streamed", cluster=1, **kw),
        vr.votes_routing_plain(t(u), t(w), mode="streamed", **kw),
        rtol=0, atol=0)


def test_forward_without_a_cluster_takes_the_planners_size():
    """Streamed votes without a cluster named take the planner's size for
    that placement and i-tile at the call's batch; the split routing
    likewise; the oracle on a named cluster equals K4 on it."""
    u, w, r, j, iters, bi = _inputs("svhn-smoke", seed=40)
    t = torch.from_numpy
    i_dim, c = u.shape[1:]
    for mode in ("streamed", STREAMED_GLOBAL):
        cs = execplan.plan_votes_routing_cluster(
            i_dim, c, w.shape[1], j, iters=iters, batch=BATCH, votes=mode,
            block_i=bi).cluster.cluster
        assert cs == vr.planned_cluster(i_dim, c, w.shape[1], j, iters,
                                        BATCH, mode, bi)
        torch.testing.assert_close(
            vr.votes_routing(t(u), t(w), iters=iters, num_classes=j,
                             mode=mode, block_i=bi),
            vr.cluster_routing_plain(t(u), t(w), iters=iters, num_classes=j,
                                     mode=mode, block_i=bi, cluster=cs),
            rtol=0, atol=0)
    uh = torch.from_numpy(_rand(41, BATCH, 64, 80, scale=0.3))
    mode, block_i, cs = ops.planned_routing(64, 10, 80, 3, BATCH)
    torch.testing.assert_close(
        ops.routing(uh, iters=3, num_classes=10),
        k14b.routing_plain(uh, iters=3, num_classes=10, mode=mode,
                           block_i=block_i, cluster=cs), rtol=0, atol=0)
    # The oracle K13 on a named cluster equals K4 on it bit for bit.
    kw13 = dict(iters=iters, num_classes=j, block_i=bi, cluster=4)
    torch.testing.assert_close(
        vr.votes_routing(t(u), t(w), mode=execplan.ORACLE_MODE, **kw13),
        vr.votes_routing(t(u), t(w), mode="streamed", **kw13), rtol=0,
        atol=0)
    with pytest.raises(ValueError, match="cluster of 3"):
        k14b.routing(uh, cluster=3)


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------

def test_mnist_per_op_classcaps_is_resident_on_a_cluster():
    """One MNIST sample's votes (737,280 B) fit no CTA, but a cluster CTA's
    rows' votes do: the per-op ClassCaps runs K3, not a streamed K4."""
    op = compile_plan(capsnet_mnist.config(), batch=8).op(
        execplan.FUSED_NAME)
    assert (op.mode, op.n_passes) == ("resident", 1)
    assert op.cluster in CLUSTER_SIZES and op.cluster >= 4
    assert op.block_i == op.block.rows == -(-1152 // op.cluster)
    assert op.smem_bytes == execplan.votes_routing_cluster_smem(
        1152, 8, 10, 160, op.cluster)
    # Named streamed votes plan a cluster too, at their largest tile.
    sched = execplan.plan_votes_routing_cluster(1152, 8, 160, 10, batch=8,
                                                votes="streamed")
    assert sched.mode == "streamed" and sched.n_passes == 4
    assert sched.smem_bytes <= planner.SMEM_BYTES


def test_svhn_per_op_bottleneck_streams_with_its_logits_on_chip():
    """2048 capsules routed to 64 x 8D: the logits of a sample (524 KB) fit
    a CTA's share from 4 CTAs up, so K4 streams the votes with the logits
    on chip; below 4 CTAs only streamed-global fits."""
    op = compile_plan(capsnet_svhn.config(), batch=8).op(
        "ClassCaps-Routing[0]")
    assert (op.mode, op.n_passes, op.block_i) == ("streamed", 4, 64)
    assert op.cluster in (4, 8, 16)
    for cs, want in ((1, STREAMED_GLOBAL), (2, STREAMED_GLOBAL),
                     (4, "streamed"), (8, "streamed"), (16, "streamed")):
        sched = execplan.plan_votes_routing_cluster(2048, 8, 512, 64,
                                                    batch=8, cluster=cs)
        assert sched.mode == want and sched.cluster.cluster == cs
        assert sched.smem_bytes == execplan.votes_routing_cluster_smem(
            2048, 8, 64, 512, cs, mode=want, block_i=sched.block_i)


def test_cifar10_full_width_forward_plans_streamed_global_on_a_cluster():
    """CIFAR-10's full-width halves (1024 -> 1024 x 8D): even a 16-CTA
    cluster's rows' logits (64 x 1024 fp32) fit no CTA, so the forward
    keeps them in device memory on a cluster; the training plan still
    raises, naming the first ``-bwd`` op whose emit fits no CTA."""
    plan = compile_plan(capsnet_cifar10.config(), batch=8)
    halves = [plan.op(f"ClassCaps-Routing[{k}]") for k in range(6)]
    assert all(op.mode == STREAMED_GLOBAL and op.cluster in CLUSTER_SIZES
               for op in halves)
    assert 64 * 1024 * 4 > planner.SMEM_BYTES
    with pytest.raises(PlanError, match=r"ClassCaps-Routing\[5\]-bwd"):
        compile_plan(capsnet_cifar10.config(), batch=8, train=True)


@pytest.mark.parametrize("cfg", [capsnet_mnist.config(), capsnet_svhn.config(),
                                 capsnet_cifar10.config()],
                         ids=["mnist", "svhn", "cifar10"])
def test_every_forward_footprint_fits_at_batches_1_to_64(cfg):
    """Every routing op of the per-op forward and K14b at MNIST width plan
    a cluster whose footprint (the kernel's layout) fits, at every batch
    from 1 to 64."""
    for batch in (1, 2, 3, 8, 16, 33, 64):
        plan = compile_plan(cfg, batch=batch)
        for lay in cfg.routing_stack():
            op = plan.op(lay.name)
            assert op.cluster in CLUSTER_SIZES
            assert op.block.ctas == batch * op.cluster
            assert op.smem_bytes == execplan.votes_routing_cluster_smem(
                lay.in_caps, lay.in_dim, lay.num_caps, lay.jd, op.cluster,
                mode=op.mode, block_i=op.block_i) <= planner.SMEM_BYTES
        sched = execplan.plan_routing_split(1152, 10, 160, batch=batch)
        assert sched.smem_bytes == execplan.routing_split_cluster_smem(
            sched.mode, 1152, sched.block_i, 10, 160,
            sched.cluster.cluster) <= planner.SMEM_BYTES


def test_plan_errors_where_nothing_fits():
    """Under a budget that not even a 16-CTA cluster streaming one row
    with its logits in device memory fits, K4's plan raises naming the op
    and the placement, and K14b's plan raises naming ``routing``."""
    with pytest.raises(PlanError, match=r"Hidden-Routing.*streamed-global"):
        execplan.plan_votes_routing(2048, 8, 512, 64, smem_budget=14_000,
                                    name="Hidden-Routing")
    assert execplan.plan_votes_routing_cluster(
        2048, 8, 512, 64, smem_budget=14_000) is None
    with pytest.raises(PlanError, match="routing"):
        execplan.plan_routing_split(2048, 64, 512, smem_budget=8_000)
    with pytest.raises(ValueError, match="no cluster"):
        vr.planned_cluster(2048, 8, 512, 64, 3, 1, "resident")


def test_k14b_plan_keeps_the_rows_on_chip_at_mnist_width():
    """At MNIST width (1152 x 160) each CTA of K14b's cluster holds its
    rows of u_hat (144 x 161 floats at 8 CTAs), so u_hat is read once a
    sample; where no size fits resident rows, the plan streams."""
    for batch in (1, 8, 16):
        mode, block_i, cs = ops.planned_routing(1152, 10, 160, 3, batch)
        assert mode == "resident" and cs >= 4
        assert block_i == -(-1152 // cs)
    sched = execplan.plan_routing_split(8192, 10, 160, batch=8)
    assert sched.mode == "streamed" and sched.n_passes == 4
