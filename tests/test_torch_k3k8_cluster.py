"""K3 (the resident votes + routing forward) and K8 (its backward) on the
cluster core, against the JAX reference on the CPU.

On the card each sample routes over a thread-block cluster of ``cs`` CTAs
(``csrc/votes_routing.cu``'s ``votes_routing_cluster_kernel`` and
``csrc/votes_routing_bwd.cu``'s ``routing_bwd_cluster_kernel`` with
resident votes); on the CPU the twins follow the cluster's order: each rank
sums s (and the backward's dv) over its own block of rows, and the ranks'
partials are added in rank order (``cluster_routing_plain`` plus the
residual, ``votes_routing_bwd_plain(..., mode="resident", cluster=cs)``).
They are held to the reference's Pallas kernels in interpret mode at the
SVHN ResCaps half's shape (32 x 8D routed to 32 x 8D), at its ClassCaps'
(64 x 8D to 10 x 16D) and at a ragged capsule count that no cluster size
divides, at the reference's tolerances (rtol 1e-5 / atol 1e-6).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import votes_routing as ref_vr
from repro_torch.configs import capsnet_mnist, capsnet_svhn
from repro_torch.core import execplan
from repro_torch.core.execplan import CLUSTER_SIZES, compile_plan
from repro_torch.kernels import ops
from repro_torch.kernels import votes_routing as vr

TOL = dict(rtol=1e-5, atol=1e-6)
BATCH = 3
# (I, C, J, D): the SVHN ResCaps half, its ClassCaps, a ragged I.
SHAPES = {"svhn-half": (32, 8, 32, 8), "svhn-classcaps": (64, 8, 10, 16),
          "ragged": (27, 4, 5, 8)}


def _rand(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _inputs(name, seed=0):
    i_dim, c, j, d = SHAPES[name]
    return (_rand(seed, BATCH, i_dim, c, scale=0.5),
            _rand(seed + 1, i_dim, j * d, c, scale=0.3),
            _rand(seed + 2, BATCH, j * d, scale=0.1),
            _rand(seed + 3, BATCH, j * d), j)


def _statics(j, i_dim):
    return ref_vr._VRStatics(iters=3, num_classes=j, mode="resident",
                             block_i=min(8, i_dim), bwd_mode="resident",
                             bwd_block_i=min(8, i_dim), interpret=True)


@pytest.mark.parametrize("residual", [False, True], ids=["v", "v+r"])
@pytest.mark.parametrize("cs", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_k3_cluster_twin_matches_reference(name, cs, residual):
    """K3's twin on a cs-CTA cluster, with and without the residual
    epilogue, against the reference's resident kernel (``_vr_core`` /
    ``_vr_core_res``)."""
    u, w, r, _, j = _inputs(name)
    st = _statics(j, u.shape[1])
    if residual:
        want = ref_vr._vr_core_res(st, *map(jnp.asarray, (u, w, r)))
    else:
        want = ref_vr._vr_core(st, jnp.asarray(u), jnp.asarray(w))
    t = torch.from_numpy
    got = vr.votes_routing(t(u), t(w), r=t(r) if residual else None,
                           iters=3, num_classes=j, mode="resident",
                           block_i=8, cluster=cs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    twin = vr.cluster_routing_plain(t(u), t(w), iters=3, num_classes=j,
                                    mode="resident", block_i=8, cluster=cs)
    torch.testing.assert_close(got, twin + t(r) if residual else twin,
                               rtol=0, atol=0)


@pytest.mark.parametrize("cs", [1, 2, 4])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_k8_cluster_twin_matches_reference(name, cs):
    """K8's twin (resident votes on a cs-CTA cluster) against ``jax.vjp``
    of the reference's resident op (its backward kernel in interpret
    mode): the cotangents of u and W, and through the autograd Function
    of the residual-epilogue op, of r."""
    u, w, r, g, j = _inputs(name, seed=10)
    st = _statics(j, u.shape[1])
    _, pull = jax.vjp(lambda a, b, c: ref_vr._vr_core_res(st, a, b, c),
                      *map(jnp.asarray, (u, w, r)))
    du_want, dw_want, dr_want = pull(jnp.asarray(g))
    t = torch.from_numpy
    du, dw = vr.votes_routing_bwd(t(u), t(w), t(g), iters=3, num_classes=j,
                                  mode="resident", block_i=8, cluster=cs)
    np.testing.assert_allclose(du.numpy(), np.asarray(du_want), **TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(dw_want), **TOL)
    uu, ww, rr = (t(x).requires_grad_() for x in (u, w, r))
    vr.votes_routing(uu, ww, r=rr, iters=3, num_classes=j, mode="resident",
                     block_i=8, cluster=cs, bwd_mode="resident",
                     bwd_cluster=cs).backward(t(g))
    torch.testing.assert_close(uu.grad, du, rtol=0, atol=0)
    torch.testing.assert_close(ww.grad, dw, rtol=0, atol=0)
    np.testing.assert_allclose(rr.grad.numpy(), np.asarray(dr_want), **TOL)


@pytest.mark.parametrize("cs", [2, 4])
def test_k12_segment_on_clusters_matches_reference(cs):
    """Two ResCaps blocks (K12) whose halves run K3 and K8 on cs-CTA
    clusters (11 capsules: ragged rank blocks) against the reference's
    segment, forward and ``jax.grad`` of x and every half-weight."""
    i_dim, c, i1 = 11, 4, 5
    x = _rand(40, 2, i_dim, c, scale=0.5)
    ws = [_rand(41 + k, *shape, scale=0.3) for k, shape in enumerate(
        [(i_dim - i1, i1 * c, c), (i1, (i_dim - i1) * c, c)] * 2)]
    g = _rand(50, 2, i_dim, c)
    st_f = (3, i1, "resident", 8, "resident", 8)
    st_g = (3, i_dim - i1, "resident", 8, "resident", 8)
    ref_blocks = ((i1, st_f, st_g),) * 2

    def loss(x_, *ws_):
        return jnp.sum(ref_vr.res_caps_segment(
            x_, ws_, blocks=ref_blocks, interpret=True) * jnp.asarray(g))

    want_y = ref_vr.res_caps_segment(jnp.asarray(x),
                                     tuple(map(jnp.asarray, ws)),
                                     blocks=ref_blocks, interpret=True)
    want = jax.grad(loss, argnums=tuple(range(5)))(
        jnp.asarray(x), *map(jnp.asarray, ws))
    blocks = tuple((i1, vr.RoutingStatics(*sf, cluster=cs, bwd_cluster=cs),
                    vr.RoutingStatics(*sg, cluster=cs, bwd_cluster=cs))
                   for _, sf, sg in ref_blocks)
    ts = [torch.from_numpy(a).requires_grad_() for a in [x] + ws]
    y = vr.res_caps_segment(ts[0], ts[1:], blocks=blocks)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y),
                               **TOL)
    torch.sum(y * torch.from_numpy(g)).backward()
    for t, want_g in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_g),
                                   **TOL)


def test_resident_without_a_cluster_takes_the_planners_size():
    """Resident votes always run on a cluster: without one named, K3 and
    K8 take the planner's size at the call's batch, the same one the
    twins use; the oracle runs on a named cluster too."""
    u, w, r, g, j = _inputs("svhn-half", seed=20)
    t = torch.from_numpy
    i_dim, c = u.shape[1:]
    cs = execplan.plan_votes_routing_cluster(i_dim, c, w.shape[1], j,
                                             batch=BATCH).cluster.cluster
    torch.testing.assert_close(
        vr.votes_routing(t(u), t(w), r=t(r), iters=3, num_classes=j,
                         mode="resident", block_i=8),
        vr.cluster_routing_plain(t(u), t(w), iters=3, num_classes=j,
                                 mode="resident", block_i=8, cluster=cs)
        + t(r), rtol=0, atol=0)
    bcs = execplan.plan_routing_bwd_cluster(
        i_dim, c, w.shape[1], j, batch=BATCH,
        votes="resident").cluster.cluster
    for got, want in zip(
            vr.votes_routing_bwd(t(u), t(w), t(g), iters=3, num_classes=j,
                                 mode="resident", block_i=8),
            vr.votes_routing_bwd_plain(t(u), t(w), t(g), iters=3,
                                       num_classes=j, mode="resident",
                                       block_i=8, cluster=bcs)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    # The oracle K13 on a named cluster: K4's streamed votes on the unfused
    # schedule, equal to K4 on that cluster bit for bit.
    kw13 = dict(iters=3, num_classes=j, block_i=8, cluster=2)
    torch.testing.assert_close(
        vr.votes_routing(t(u), t(w), mode=execplan.ORACLE_MODE, **kw13),
        vr.votes_routing(t(u), t(w), mode="streamed", **kw13), rtol=0,
        atol=0)
    with pytest.raises(ValueError, match="cluster of 3"):
        vr.votes_routing(t(u), t(w), iters=3, num_classes=j,
                         mode="resident", block_i=8, cluster=3)


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cs", CLUSTER_SIZES)
def test_k3_footprint_is_the_kernels_layout(cs):
    """``votes_routing_cluster_smem`` is the kernel's ``cluster_fwd_layout``
    in bytes: each CTA's ceil(I / cs) votes rows (J*D + 1 floats) with
    their couplings, the rows' u and logits, and s, v and two partials."""
    i_dim, c, j, d = SHAPES["svhn-half"]
    rows = math.ceil(i_dim / cs)
    jd = j * d
    assert execplan.votes_routing_cluster_smem(i_dim, c, j, jd, cs) == 4 * (
        rows * (jd + 1 + j) + rows * (c + j) + 4 * jd)
    sched = execplan.plan_votes_routing_cluster(i_dim, c, jd, j, batch=8,
                                                cluster=cs)
    assert (sched.mode, sched.block_i, sched.n_passes) == ("resident",
                                                           rows, 1)
    assert sched.cluster.tiles[:3] == (cs, rows, 8 * cs)


def test_k3_plan_is_none_where_no_cluster_fits():
    assert execplan.plan_votes_routing_cluster(64, 8, 160, 10,
                                               smem_budget=4_000,
                                               votes="resident") is None
    with pytest.raises(ValueError, match="no cluster"):
        vr.planned_cluster(100_000, 8, 160, 10, 3, 1)


def test_streamed_forward_plans_are_clusters():
    """Where one sample's votes fit no CTA the forward still runs on a
    cluster: the MNIST ClassCaps with each CTA's rows' votes resident
    (K3), the SVHN bottleneck (per-op plan) streaming them with its logits
    on chip (K4)."""
    for cfg, name, mode in (
            (capsnet_mnist.config(), execplan.FUSED_NAME, "resident"),
            (capsnet_svhn.config(), "ClassCaps-Routing[0]", "streamed")):
        op = compile_plan(cfg, batch=8, pipeline=False).op(name)
        assert op.mode == mode
        assert isinstance(op.block, execplan.ClusterPlan)
        assert op.cluster in CLUSTER_SIZES and op.cluster > 1


def test_planless_ops_plan_k3_at_the_calls_batch():
    """Without a plan ``ops.votes_routing`` takes the memoized decision at
    the call's batch, cluster included."""
    u, w, _, _, j = _inputs("svhn-classcaps", seed=30)
    mode, block_i, cs = ops.planned_votes_routing(u.shape[1], u.shape[2],
                                                  w.shape[1], j, 3, BATCH)
    assert mode == "resident" and cs in CLUSTER_SIZES
    t = torch.from_numpy
    torch.testing.assert_close(
        ops.votes_routing(t(u), t(w), iters=3, num_classes=j),
        vr.cluster_routing_plain(t(u), t(w), iters=3, num_classes=j,
                                 mode=mode, block_i=block_i, cluster=cs),
        rtol=0, atol=0)
