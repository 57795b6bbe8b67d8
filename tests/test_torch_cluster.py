"""The cluster routing schedules (K5 ``primary_routing``, K9 the routing
backward) against the JAX reference, and their plans.

On the card each sample routes over a thread-block cluster of ``cs`` CTAs
(``csrc/routing_cluster.cuh``); on the CPU the plain twins follow the same
schedule math: each rank sums s (and the backward's dv) over its own rows,
and the ranks' partials are added in rank order.  The twins are held to the
reference's Pallas kernels in interpret mode at the MNIST and SVHN smoke
widths, at the reference's tolerances (rtol 1e-5 / atol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.core import execplan as ref_execplan
from repro.kernels import votes_routing as ref_vr
from repro.kernels.primary_routing import primary_caps_routing
from repro_torch.configs import capsnet_mnist, capsnet_svhn
from repro_torch.core import execplan, planner
from repro_torch.core.execplan import (BWD_SUFFIX, CLUSTER_SIZES, PIPE_NAME,
                                       ClusterPlan, compile_plan)
from repro_torch.kernels import primary_routing as k5
from repro_torch.kernels import ref
from repro_torch.kernels import routing as k14b
from repro_torch.kernels import votes_routing as vr

TOL = dict(rtol=1e-5, atol=1e-6)
# The smoke configs whose first routing layer (ClassCaps at MNIST, the
# bottleneck at SVHN) the tests route.
SMOKE = {"mnist": capsnet_mnist.smoke_config(),
         "svhn": capsnet_svhn.smoke_config()}


def _rand(seed, *shape, scale=1.0, uniform=False):
    rng = np.random.default_rng(seed)
    x = rng.random(shape) if uniform else rng.standard_normal(shape)
    return (scale * x).astype(np.float32)


def _pipe_inputs(name, seed=0, bsz=2):
    """Seeded K5 inputs at a smoke config's shapes: the Conv1 output x, the
    PrimaryCaps conv weights and bias, the first routing layer's W."""
    cfg = SMOKE[name]
    lay = cfg.routing_stack()[0]
    x = _rand(seed, bsz, cfg.conv1_out, cfg.conv1_out, cfg.conv1_channels,
              uniform=True)
    w_pc = _rand(seed + 1, cfg.pc_kernel, cfg.pc_kernel, cfg.conv1_channels,
                 cfg.pc_channels, scale=0.2)
    b_pc = _rand(seed + 2, cfg.pc_channels, scale=0.1)
    w_cc = _rand(seed + 3, lay.in_caps, lay.jd, lay.in_dim, scale=0.3)
    return cfg, lay, (x, w_pc, b_pc, w_cc)


@pytest.mark.parametrize("mode", ["resident", "streamed"])
@pytest.mark.parametrize("cs", [1, 2, 4])
@pytest.mark.parametrize("name", ["mnist", "svhn"])
def test_primary_routing_cluster_matches_reference(name, cs, mode):
    """K5's twin on a cs-CTA cluster (each rank's groups at every
    position) against the reference's pipelined kernel."""
    cfg, lay, args = _pipe_inputs(name)
    kw = dict(stride=cfg.pc_stride, iters=lay.iters,
              num_classes=lay.num_caps, mode=mode, block_i=8)
    want = primary_caps_routing(*map(jnp.asarray, args), block_k=32,
                                interpret=True, **kw)
    got = k5.primary_routing(*map(torch.from_numpy, args), cluster=cs, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", ["resident", "streamed"])
@pytest.mark.parametrize("cs", [1, 2, 4])
@pytest.mark.parametrize("name", ["mnist", "svhn"])
def test_routing_bwd_cluster_matches_reference(name, cs, mode):
    """K9's twin on a cs-CTA cluster (contiguous row blocks, the last
    ragged at SVHN's 100 capsules over 4) against the reference's custom
    VJP (Pallas, interpret mode): the output and the cotangents of u and
    W."""
    lay = SMOKE[name].routing_stack()[0]
    u = _rand(10, 2, lay.in_caps, lay.in_dim, scale=0.5)
    w = _rand(11, lay.in_caps, lay.jd, lay.in_dim, scale=0.3)
    g = _rand(12, 2, lay.jd)
    kw = dict(iters=lay.iters, num_classes=lay.num_caps, mode=mode,
              block_i=8)
    want, pull = jax.vjp(lambda a, b: ref_vr.votes_routing(
        a, b, bwd_mode=mode, bwd_block_i=8, interpret=True, **kw),
        jnp.asarray(u), jnp.asarray(w))
    du_want, dw_want = pull(jnp.asarray(g))
    uu, ww = (torch.from_numpy(x).requires_grad_() for x in (u, w))
    got = vr.votes_routing(uu, ww, bwd_mode=mode, bwd_block_i=8,
                           bwd_cluster=cs, **kw)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(uu.grad.numpy(), np.asarray(du_want), **TOL)
    np.testing.assert_allclose(ww.grad.numpy(), np.asarray(dw_want), **TOL)
    du, dw = vr.votes_routing_bwd(*map(torch.from_numpy, (u, w, g)),
                                  cluster=cs, **kw)
    torch.testing.assert_close(du, uu.grad, rtol=0, atol=0)
    torch.testing.assert_close(dw, ww.grad, rtol=0, atol=0)


def test_primary_routing_cluster_grads_match_reference():
    """The pipelined op's gradients with the routing backward on a 2-CTA
    cluster, against ``jax.grad`` of the reference's op."""
    cfg, lay, args = _pipe_inputs("mnist", seed=20)
    g = _rand(25, 2, lay.jd)
    kw = dict(stride=cfg.pc_stride, iters=lay.iters,
              num_classes=lay.num_caps, mode="resident", block_i=8)

    def loss(*a):
        return jnp.sum(primary_caps_routing(
            *a, block_k=32, bwd_block_i=8, conv_block_m=16, conv_block_k=8,
            conv_block_n=8, interpret=True, **kw) * jnp.asarray(g))

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(
        *map(jnp.asarray, args))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    out = k5.primary_routing(*ts, cluster=2, bwd_mode="resident",
                             bwd_block_i=8, bwd_cluster=2, **kw)
    torch.sum(out * torch.from_numpy(g)).backward()
    for t, y in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(y), **TOL)


# ---------------------------------------------------------------------------
# The schedule math: rank order, and cs = 1 is the single-CTA order
# ---------------------------------------------------------------------------

def test_one_rank_is_the_single_cta_order():
    """With cs = 1 the twins reduce to the single-CTA sums, bit for bit:
    the split routing's forward, the oracle K13's forward (the
    reference's two-pass order, ``votes_routing_plain``), and its
    backward, whose separate b-pass leaves the fused replay's logits."""
    u = torch.from_numpy(_rand(30, 2, 64, 4, scale=0.5))
    w = torch.from_numpy(_rand(31, 64, 40, 4, scale=0.3))
    g = torch.from_numpy(_rand(32, 2, 40))
    kw = dict(iters=3, num_classes=5, block_i=16)
    votes = torch.einsum("bic,inc->bin", u, w)
    torch.testing.assert_close(
        vr.cluster_routing_plain(u, w, mode="streamed", cluster=1, **kw),
        k14b.routing_plain(votes, **kw), rtol=0, atol=0)
    torch.testing.assert_close(
        vr.cluster_routing_plain(u, w, mode=execplan.ORACLE_MODE, cluster=1,
                                 **kw),
        vr.votes_routing_plain(u, w, mode=execplan.ORACLE_MODE, **kw),
        rtol=0, atol=0)
    for got, want in zip(
            vr.votes_routing_bwd_plain(u, w, g, mode="streamed", cluster=1,
                                       **kw),
            vr.votes_routing_bwd_plain(u, w, g, mode=execplan.ORACLE_MODE,
                                       cluster=1, **kw)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("i_dim,cs", [(64, 4), (100, 16), (27, 16)])
def test_cluster_spans_cover_the_rows_once(i_dim, cs):
    spans = vr.cluster_spans(i_dim, cs)
    assert len(spans) == cs and spans[0][0] == 0 and spans[-1][1] == i_dim
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    rows = -(-i_dim // cs)
    assert all(hi - lo <= rows for lo, hi in spans)


def test_k5_ranks_own_whole_groups_at_every_position():
    """Rank r's rows are its groups at each position, in (position,
    group) order: with 4 groups at 3 positions over 2 ranks, rank 0 owns
    rows 0, 1, 4, 5, 8, 9 and rank 1 the rest."""
    p_pos, groups, c = 3, 4, 2
    i_dim = p_pos * groups
    patches = torch.from_numpy(_rand(40, 1, p_pos, 6))
    w_pc = torch.from_numpy(_rand(41, 6, groups * c, scale=0.3))
    b_pc = torch.from_numpy(_rand(43, groups * c, scale=0.1))
    w_cc = torch.from_numpy(_rand(42, i_dim, 6, c, scale=0.3))
    kw = dict(iters=2, num_classes=3, mode="resident", block_i=4)
    u = ref.squash((patches @ w_pc + b_pc).reshape(1, i_dim, c))
    order = [0, 1, 4, 5, 8, 9, 2, 3, 6, 7, 10, 11]
    torch.testing.assert_close(
        k5.primary_routing_patches_plain(patches, w_pc, b_pc, w_cc,
                                         cluster=2, **kw),
        vr.cluster_routing_plain(u[:, order], w_cc[order], cluster=2, **kw),
        rtol=0, atol=0)


def test_cluster_arguments_are_checked():
    u, w, g = torch.zeros(1, 12, 4), torch.zeros(12, 20, 4), torch.zeros(1,
                                                                         20)
    with pytest.raises(ValueError, match="cluster of 3"):
        vr.votes_routing_bwd(u, w, g, num_classes=5, cluster=3)
    with pytest.raises(ValueError, match="cluster of 3"):
        vr.votes_routing_bwd(u, w, g, num_classes=5, cluster=3,
                             mode=execplan.ORACLE_MODE)
    x = torch.zeros(1, 7, 7, 3)
    with pytest.raises(ValueError, match="cluster of 4"):
        k5.primary_routing(x, torch.zeros(3, 3, 3, 8), torch.zeros(8),
                           torch.zeros(18, 16, 4), num_classes=4, cluster=4)


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------

FULL = {"mnist": capsnet_mnist.config(), "svhn": capsnet_svhn.config()}


@pytest.mark.parametrize("name", ["mnist", "svhn"])
def test_every_cluster_cta_fits_at_batches_1_to_64(name):
    """Each cluster CTA's modeled footprint is within a CTA's budget at
    every batch, its cluster divides the capsule groups, and the grid is
    batch x cs CTAs."""
    cfg = FULL[name]
    for batch in (1, 2, 3, 8, 16, 33, 64):
        plan = compile_plan(cfg, batch=batch, pipeline=True, train=True)
        assert all(0 < op.smem_bytes <= planner.SMEM_BYTES
                   for op in plan.ops)
        pr = plan.op(PIPE_NAME)
        assert isinstance(pr.block, ClusterPlan)
        assert cfg.num_primary_groups % pr.cluster == 0
        assert pr.block.ctas == batch * pr.cluster
        lay = cfg.routing_stack()[0]
        assert pr.smem_bytes == execplan.primary_routing_smem(
            pr.mode, cfg.pc_out ** 2, cfg.pc_channels, pr.block_i,
            cfg.primary_dim, lay.num_caps, lay.jd, pr.cluster)
        # Every routing op on a cluster (K3 forward, K8/K9 backward) takes
        # ceil(I / cs) rows a CTA, batch x cs CTAs.
        for k, lay_ in enumerate(cfg.routing_stack()):
            for op in (plan.op(lay_.name) if k else None,
                       plan.op(lay_.name + BWD_SUFFIX)):
                if op is None or op.cluster is None:
                    continue
                assert op.cluster in CLUSTER_SIZES
                assert op.block.rows == -(-lay_.in_caps // op.cluster)
                assert op.block.ctas == batch * op.cluster
        assert plan.op(lay.name + BWD_SUFFIX).cluster in CLUSTER_SIZES


def test_clusters_fill_the_card_at_the_serving_batch():
    """At batch 8 one CTA a sample would leave 124 of 132 SMs idle: the
    plan spreads each sample over more than one CTA."""
    plan = compile_plan(capsnet_mnist.config(), batch=8, pipeline=True)
    pr = plan.op(PIPE_NAME)
    assert pr.cluster > 1 and pr.block.ctas == 8 * pr.cluster
    assert pr.block.waves == execplan.cluster_waves(8, pr.cluster)


def test_svhn_pipelines_as_the_reference_does():
    """The SVHN bottleneck's logits fit a cluster's CTAs, so the pipelined
    plan has the reference's ops and its consume mode."""
    plan = compile_plan(capsnet_svhn.config(), batch=8, pipeline=True)
    ref = ref_execplan.compile_plan(ref_registry.get_config("capsnet-svhn"),
                                    batch=8, pipeline=True)
    assert [op.name for op in plan.ops] == [op.name for op in ref.ops]
    assert plan.op(PIPE_NAME).mode == ref.op(PIPE_NAME).mode == "streamed"


def test_k3_k8_and_k13_plans_are_unchanged():
    """K3 and K8 keep their resident votes, now each sample on a cluster:
    at every batch the SVHN ResCaps halves' and ClassCaps' forward and
    ``-bwd`` ops are cluster plans of ceil(I / cs) rows a CTA whose
    footprint fits; K13b replays on K9's cluster, in K9's footprint."""
    cfg = capsnet_svhn.config()
    for batch in (1, 2, 3, 8, 16, 33, 64):
        plan = compile_plan(cfg, batch=batch, train=True)
        for lay in cfg.routing_stack()[1:]:
            for op in (plan.op(lay.name), plan.op(lay.name + BWD_SUFFIX)):
                assert op.mode == "resident" and op.n_passes == 1
                assert op.cluster in CLUSTER_SIZES
                assert op.block.rows == -(-lay.in_caps // op.cluster)
                assert 0 < op.smem_bytes <= planner.SMEM_BYTES
            hbwd = plan.op(lay.name + BWD_SUFFIX)
            assert hbwd.smem_bytes == max(
                execplan.routing_bwd_cluster_smem(
                    "resident", lay.in_caps, hbwd.block_i, lay.in_dim,
                    lay.num_caps, lay.jd, hbwd.cluster),
                execplan.routing_bwd_emit_smem(lay.in_dim, lay.num_caps,
                                               lay.jd))
    smoke = compile_plan(capsnet_mnist.smoke_config(), batch=16, train=True)
    assert smoke.op(execplan.FUSED_NAME + BWD_SUFFIX).cluster in CLUSTER_SIZES
    for i, c, j, d in ((1152, 8, 10, 16), (2048, 8, 64, 8)):
        u = torch.empty(16, i, c, device="meta")
        w = torch.empty(i, j * d, c, device="meta")
        sched = execplan.plan_routing_bwd_cluster(i, c, j * d, j, batch=16,
                                                  votes="streamed")
        mode, cs = vr.bwd_schedule(u, w, iters=3, num_classes=j,
                                   mode=execplan.ORACLE_MODE, cluster=None)
        assert (mode, cs) == (execplan.ORACLE_MODE, sched.cluster.cluster)
        assert sched.smem_bytes == max(
            execplan.routing_bwd_cluster_smem("streamed", i, sched.block_i,
                                              c, j, j * d, cs),
            execplan.routing_bwd_emit_smem(c, j, j * d))
