"""The port's CUDA kernels on the card, against their plain twins.

Every test here needs a CUDA device and the CUDA toolkit: they carry the
``gpu`` marker and skip elsewhere (``python -m pytest -m gpu
tests/test_torch_gpu.py`` on the GPU machine).  The file imports no JAX,
so it runs where only PyTorch is installed.  Inputs are small: the
full-width checks live in ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import capsnet_cifar10, capsnet_mnist, capsnet_svhn
from repro_torch.core import capsnet, execplan, planner
from repro_torch.kernels import build
from repro_torch.kernels import caps_votes as k14a
from repro_torch.kernels import conv_im2col as k12
from repro_torch.kernels import ops
from repro_torch.kernels import primary_routing as k5
from repro_torch.kernels import routing as k14b
from repro_torch.kernels import squash as k10
from repro_torch.kernels import votes_routing as k34
from repro_torch.serve.capsule import CapsRequest, CapsuleEngine

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(seed, *shape, scale=1.0, uniform=False, device="cpu"):
    rng = np.random.default_rng(seed)
    x = rng.random(shape) if uniform else rng.standard_normal(shape)
    return torch.tensor((scale * x).astype(np.float32), device=device)


def _fwd_twin(u, w, r=None, *, cluster=None, **kw):
    """The forward's plain twin on the schedule the wrapper runs: the
    cluster order of K3/K4/K13 (at the planner's size unless ``cluster``
    names one)."""
    cs = k34.fwd_cluster(u, w, iters=kw["iters"],
                         num_classes=kw["num_classes"], mode=kw["mode"],
                         cluster=cluster, block_i=kw["block_i"])
    return k34.cluster_routing_plain(u, w, cluster=cs, r=r, **kw)


def test_kernels_launch_and_match_twins_on_the_card(cuda):
    build.reset_launch_counts()
    x = _rand(1, 2, 10, 10, 8, uniform=True, device=cuda)
    w_pc = _rand(2, 3, 3, 8, 16, scale=0.2, device=cuda)
    b_pc = _rand(3, 16, scale=0.1, device=cuda)
    w_cc = _rand(4, 64, 32, 4, scale=0.3, device=cuda)
    p = k12.im2col_patches(x, kh=3, kw=3, stride=2)
    torch.testing.assert_close(
        p, k12.im2col_patches_plain(x, kh=3, kw=3, stride=2), rtol=0, atol=0)
    p2 = p.reshape(-1, p.shape[2])
    w2 = w_pc.reshape(-1, 16)
    for epi, sd in (("none", 0), ("relu", 0), ("squash", 4)):
        torch.testing.assert_close(
            k12.matmul_bias_act(p2, w2, b_pc, block_m=64, block_k=16,
                                block_n=32, epilogue=epi, squash_dim=sd),
            k12.matmul_bias_act_plain(p2, w2, b_pc, epilogue=epi,
                                      squash_dim=sd), rtol=1e-5, atol=1e-5)
    u = _rand(5, 2, 64, 4, scale=0.5, device=cuda)
    for mode in ("resident", "streamed"):
        kw = dict(iters=3, num_classes=4, mode=mode, block_i=24)
        torch.testing.assert_close(k34.votes_routing(u, w_cc, **kw),
                                   _fwd_twin(u, w_cc, **kw),
                                   rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(
            k5.primary_routing_patches(p, w2, b_pc, w_cc, **kw),
            k5.primary_routing_patches_plain(p, w2, b_pc, w_cc, **kw),
            rtol=1e-5, atol=1e-6)
    counts = build.launch_counts()
    for sym in ("im2col_patches_f32", "matmul_bias_act_f32",
                "votes_routing_streamed_cluster_f32",
                "votes_routing_cluster_f32", "primary_routing_f32"):
        assert counts[sym] > 0, sym


@pytest.mark.parametrize("cs", [1, 2, 4])
def test_cluster_kernels_match_twins_with_identical_bits(cuda, cs):
    """K3, K4 (both placements of the logits), K5, K8/K9 and K14b (u_hat
    rows resident and streamed) on clusters of cs CTAs against their
    twins (the twins sum s and dv rank by rank, in rank order), and a
    second launch of each repeats the bits (no float atomics); the
    oracle K13 (forward and backward) equals K4 and K9 on the same
    cluster bit for bit."""
    build.reset_launch_counts()
    x = _rand(30, 3, 10, 10, 8, uniform=True, device=cuda)
    w_pc = _rand(31, 3, 3, 8, 16, scale=0.2, device=cuda)
    b_pc = _rand(32, 16, scale=0.1, device=cuda)
    w_cc = _rand(33, 64, 32, 4, scale=0.3, device=cuda)
    p = k12.im2col_patches(x, kh=3, kw=3, stride=2)
    w2 = w_pc.reshape(-1, 16)
    u = _rand(34, 3, 100, 4, scale=0.5, device=cuda)
    w = _rand(35, 100, 40, 4, scale=0.3, device=cuda)
    g = _rand(36, 3, 40, device=cuda)
    for mode in ("resident", "streamed"):
        kw = dict(iters=3, num_classes=4, mode=mode, block_i=8, cluster=cs)
        got = k5.primary_routing_patches(p, w2, b_pc, w_cc, **kw)
        assert torch.equal(got, k5.primary_routing_patches(p, w2, b_pc,
                                                           w_cc, **kw))
        torch.testing.assert_close(
            got, k5.primary_routing_patches_plain(p, w2, b_pc, w_cc, **kw),
            rtol=1e-5, atol=1e-6)
        kw["num_classes"] = 5
        r = _rand(37, 3, 40, scale=0.1, device=cuda)
        # K3 (resident) or K4 and K4g (streamed), with the residual.
        v = {}
        for m in ((mode,) if mode == "resident"
                  else (mode, execplan.STREAMED_GLOBAL)):
            kwm = dict(kw, mode=m)
            v[m] = k34.votes_routing(u, w, r=r, **kwm)
            assert torch.equal(v[m], k34.votes_routing(u, w, r=r, **kwm))
            torch.testing.assert_close(v[m], _fwd_twin(u, w, r, **kwm),
                                       rtol=1e-5, atol=1e-6)
        uh = _rand(38, 3, 100, 40, scale=0.1, device=cuda)
        kwr = dict(iters=3, num_classes=5, mode=mode, block_i=7, cluster=cs)
        got = k14b.routing(uh, **kwr)                       # K14b
        assert torch.equal(got, k14b.routing(uh, **kwr))
        torch.testing.assert_close(got, k14b.routing_plain(uh, **kwr),
                                   rtol=1e-5, atol=1e-6)
        got = k34.votes_routing_bwd(u, w, g, **kw)
        again = k34.votes_routing_bwd(u, w, g, **kw)
        want = k34.votes_routing_bwd_plain(u, w, g, **kw)
        for x_, y_, z_ in zip(got, again, want):
            assert torch.equal(x_, y_)
            torch.testing.assert_close(x_, z_, rtol=1e-4, atol=1e-6)
        if mode == "streamed":
            kwo = dict(kw, mode=execplan.ORACLE_MODE)
            assert torch.equal(k34.votes_routing(u, w, r=r, **kwo), v[mode])
            for x_, y_ in zip(k34.votes_routing_bwd(u, w, g, **kwo), got):
                assert torch.equal(x_, y_)
    counts = build.launch_counts()
    assert counts["primary_routing_f32"] == 4
    assert counts["votes_routing_cluster_f32"] == 2
    assert counts["votes_routing_streamed_cluster_f32"] == 2
    assert counts["votes_routing_global_cluster_f32"] == 2
    assert counts["routing_cluster_f32"] == 4
    assert counts["routing_bwd_cluster_f32"] == 4
    assert counts["votes_routing_2pass_f32"] == 1
    assert counts["routing_bwd_2pass_f32"] == 1


def test_cluster_footprint_model_matches_the_kernels(cuda):
    """The plans' modeled shared memory of K5 and of K9's replay is the
    kernels' own layout, which is what cudaFuncGetAttributes reports once
    the launch opts in; and the card holds at least one cluster of the
    plan's size at that footprint (cudaOccupancyMaxActiveClusters)."""
    import ctypes
    k5_bytes = build._library("primary_routing").primary_routing_smem_bytes
    k5_bytes.argtypes, k5_bytes.restype = [ctypes.c_int] * 8, ctypes.c_int
    k9_bytes = build._library(
        "votes_routing_bwd").routing_bwd_cluster_smem_bytes
    k9_bytes.argtypes, k9_bytes.restype = [ctypes.c_int] * 7, ctypes.c_int
    for cfg, batch in ((capsnet_mnist.config(), 8),
                       (capsnet_mnist.config(), 16),
                       (capsnet_svhn.config(), 8),
                       (capsnet_svhn.config(), 16),
                       (capsnet_mnist.smoke_config(), 4)):
        plan = execplan.compile_plan(cfg, batch=batch, pipeline=True,
                                     train=True)
        lay = cfg.routing_stack()[0]
        d = lay.caps_dim
        pr = plan.op(execplan.PIPE_NAME)
        resident = int(pr.mode == "resident")
        assert k5_bytes(cfg.pc_out ** 2, cfg.pc_channels, cfg.primary_dim,
                        lay.num_caps, d, pr.cluster, resident,
                        pr.block_i) == pr.smem_bytes
        occ = k5.occupancy(cfg.pc_out ** 2, cfg.pc_channels,
                           cfg.primary_dim, lay.num_caps, d, mode=pr.mode,
                           block_i=pr.block_i, cluster=pr.cluster)
        assert (occ["static_smem"], occ["max_dynamic_smem"]) == (
            0, pr.smem_bytes)
        assert occ["max_active_clusters"] >= 1
        bwd = plan.op(lay.name + execplan.BWD_SUFFIX)
        if bwd.cluster is None:
            continue
        replay = execplan.routing_bwd_cluster_smem(
            bwd.mode, lay.in_caps, bwd.block_i, lay.in_dim, lay.num_caps,
            lay.jd, bwd.cluster)
        assert bwd.smem_bytes == max(replay, execplan.routing_bwd_emit_smem(
            lay.in_dim, lay.num_caps, lay.jd))
        assert k9_bytes(lay.in_caps, lay.in_dim, lay.num_caps, d,
                        bwd.cluster, int(bwd.mode == "resident"),
                        bwd.block_i) == replay
        occ = k34.bwd_cluster_occupancy(lay.in_caps, lay.in_dim,
                                        lay.num_caps, d, mode=bwd.mode,
                                        block_i=bwd.block_i,
                                        cluster=bwd.cluster)
        assert (occ["static_smem"], occ["max_dynamic_smem"]) == (0, replay)
        assert occ["max_active_clusters"] >= 1


@pytest.mark.parametrize("split_k", [1, 4])
def test_k2_relu_epilogue_keeps_nan_as_torch_relu_does(cuda, split_k):
    """A poisoned input row stays NaN through K2's ReLU epilogue (direct
    and after the split-K sum), as through ``torch.relu`` and the
    reference's ``jnp.maximum``; fmaxf would turn it into zeros and let
    a corrupted slot pass as a finite result."""
    p = _rand(11, 96, 1024, device=cuda)
    p[5] = float("nan")
    w = _rand(12, 1024, 128, scale=0.05, device=cuda)
    b = _rand(13, 128, device=cuda)
    got = k12.matmul_bias_act(p, w, b, block_m=64, block_k=16, block_n=64,
                              epilogue="relu", split_k=split_k)
    want = k12.matmul_bias_act_plain(p, w, b, epilogue="relu",
                                     split_k=split_k, block_k=16)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert bool(torch.isnan(got[5]).all())
    assert not bool(torch.isnan(got[:5]).any())
    assert bool((got[~torch.isnan(want)] >= 0).all())
    torch.testing.assert_close(got[:5], want[:5], rtol=1e-5, atol=1e-5)


def test_degraded_ladder_footprints_match_the_kernels(cuda):
    """Every plan of the degrade ladder that fits (``degrade_plan`` at
    1, 1/2, 1/4 and 1/8 of the budget, batch 8, the three CapsuleNet
    archs): each routing op's planned shared memory is its kernel's own
    layout, within the reduced budget, and the card holds its cluster."""
    import ctypes
    k3_bytes = build._library(
        "votes_routing").votes_routing_cluster_smem_bytes
    k3_bytes.argtypes, k3_bytes.restype = [ctypes.c_int] * 8, ctypes.c_int
    k5_bytes = build._library("primary_routing").primary_routing_smem_bytes
    k5_bytes.argtypes, k5_bytes.restype = [ctypes.c_int] * 8, ctypes.c_int
    seen = 0
    for cfg in (capsnet_mnist.config(), capsnet_svhn.config(),
                capsnet_cifar10.config()):
        layers = {lay.name: lay for lay in cfg.routing_stack()}
        for share in (1.0, 0.5, 0.25, 0.125):
            budget = int(planner.SMEM_BYTES * share)
            try:
                plan, _ = execplan.degrade_plan(cfg, budget, batch=8,
                                                pipeline=True)
            except execplan.PlanError:
                continue
            for op in plan.ops:
                if op.kernel == "votes_routing":
                    lay = layers[op.name]
                    args = (lay.in_caps, lay.in_dim, lay.num_caps,
                            lay.caps_dim)
                    assert k3_bytes(
                        *args, op.cluster, int(op.mode == "resident"),
                        op.block_i,
                        int(op.mode == execplan.STREAMED_GLOBAL)) \
                        == op.smem_bytes <= budget, (op.name, share)
                    occ = k34.cluster_occupancy(
                        *args, cluster=op.cluster, mode=op.mode,
                        block_i=op.block_i)
                elif op.kernel == "primary_routing":
                    lay = cfg.routing_stack()[0]
                    args = (cfg.pc_out ** 2, cfg.pc_channels,
                            cfg.primary_dim, lay.num_caps, lay.caps_dim)
                    assert k5_bytes(*args, op.cluster,
                                    int(op.mode == "resident"),
                                    op.block_i) == op.smem_bytes <= budget
                    occ = k5.occupancy(*args, mode=op.mode,
                                       block_i=op.block_i,
                                       cluster=op.cluster)
                else:
                    continue
                assert occ["max_dynamic_smem"] == op.smem_bytes
                assert occ["max_active_clusters"] >= 1, (op.name, share)
                seen += 1
    assert seen >= 20


def test_k3_k8_footprint_model_matches_the_kernels(cuda):
    """K3's, K4's and K8's planned footprints (the SVHN ResCaps halves,
    bottleneck and ClassCaps, the MNIST ClassCaps and its smoke config,
    CIFAR-10's full-width halves in streamed-global) and K14b's at MNIST
    are the kernels' own layouts, and the card holds their clusters."""
    import ctypes
    k3_bytes = build._library(
        "votes_routing").votes_routing_cluster_smem_bytes
    k3_bytes.argtypes, k3_bytes.restype = [ctypes.c_int] * 8, ctypes.c_int
    for cfg in (capsnet_mnist.config(), capsnet_svhn.config(),
                capsnet_cifar10.config()):
        plan = execplan.compile_plan(cfg, batch=8, pipeline=False)
        for lay in cfg.routing_stack():
            fwd = plan.op(lay.name)
            args = (lay.in_caps, lay.in_dim, lay.num_caps, lay.caps_dim,
                    fwd.cluster)
            assert k3_bytes(*args, int(fwd.mode == "resident"), fwd.block_i,
                            int(fwd.mode == execplan.STREAMED_GLOBAL)) \
                == fwd.smem_bytes
            occ = k34.cluster_occupancy(*args[:4], cluster=fwd.cluster,
                                        mode=fwd.mode, block_i=fwd.block_i)
            assert (occ["static_smem"], occ["max_dynamic_smem"]) == (
                0, fwd.smem_bytes)
            assert occ["max_active_clusters"] >= 1
    k14b_bytes = build._library("routing").routing_cluster_smem_bytes
    k14b_bytes.argtypes = [ctypes.c_int] * 6
    k14b_bytes.restype = ctypes.c_int
    for batch in (1, 8, 16):
        sched = execplan.plan_routing_split(1152, 10, 160, batch=batch)
        cs = sched.cluster.cluster
        assert k14b_bytes(1152, 10, 16, cs, int(sched.mode == "resident"),
                          sched.block_i) == sched.smem_bytes
        occ = k14b.cluster_occupancy(1152, 10, 16, mode=sched.mode,
                                     block_i=sched.block_i, cluster=cs)
        assert occ["max_dynamic_smem"] == sched.smem_bytes
        assert occ["max_active_clusters"] >= 1
    k8_bytes = build._library(
        "votes_routing_bwd").routing_bwd_cluster_smem_bytes
    k8_bytes.argtypes, k8_bytes.restype = [ctypes.c_int] * 7, ctypes.c_int
    for cfg, batch in ((capsnet_svhn.config(), 8),
                       (capsnet_svhn.config(), 16),
                       (capsnet_mnist.smoke_config(), 16)):
        plan = execplan.compile_plan(cfg, batch=batch, pipeline=False,
                                     train=True)
        for lay in cfg.routing_stack():
            fwd, bwd = plan.op(lay.name), plan.bwd_op(lay.name)
            if fwd.mode != "resident":
                continue
            d = lay.caps_dim
            assert k3_bytes(lay.in_caps, lay.in_dim, lay.num_caps, d,
                            fwd.cluster, 1, fwd.block_i, 0) == fwd.smem_bytes
            occ = k34.cluster_occupancy(lay.in_caps, lay.in_dim,
                                        lay.num_caps, d, cluster=fwd.cluster)
            assert (occ["static_smem"], occ["max_dynamic_smem"]) == (
                0, fwd.smem_bytes)
            assert occ["max_active_clusters"] >= 1
            assert bwd.mode == "resident" and bwd.cluster is not None
            assert k8_bytes(lay.in_caps, lay.in_dim, lay.num_caps, d,
                            bwd.cluster, 1, bwd.block_i) == \
                execplan.routing_bwd_cluster_smem(
                    "resident", lay.in_caps, bwd.block_i, lay.in_dim,
                    lay.num_caps, lay.jd, bwd.cluster)


@pytest.mark.parametrize("epi,sd", [("none", 0), ("relu", 0), ("squash", 4)])
@pytest.mark.parametrize("m,k,n,bm,bk,bn,split", [
    (200, 1000, 72, 128, 16, 128, 3),  # ragged M, N and K (K % 4 == 0)
    (150, 81, 40, 64, 16, 64, 2),      # Conv1's K = 81: 4-byte copies
    (150, 81, 40, 64, 16, 40, 1),      # output tile narrower than the build
    (96, 2049, 256, 128, 16, 128, 5),  # ragged last slab, unaligned rows
], ids=["ragged", "k81-split", "k81-narrow", "odd-k-split5"])
def test_gemm_split_k_matches_twin_on_the_card(cuda, epi, sd, m, k, n, bm,
                                               bk, bn, split):
    """K2 against its twin summed in the kernel's split order, every
    epilogue; two launches on the same inputs give the same bits."""
    p = _rand(m, m, k, uniform=True, device=cuda)
    w = _rand(k, k, n, scale=0.1, device=cuda)
    bias = _rand(n, n, scale=0.1, device=cuda)
    kw = dict(block_m=bm, block_k=bk, block_n=bn, epilogue=epi,
              squash_dim=sd, split_k=split)
    build.reset_launch_counts()
    got = k12.matmul_bias_act(p, w, bias, **kw)
    again = k12.matmul_bias_act(p, w, bias, **kw)
    assert k12.GEMM.launches == 2
    want = k12.matmul_bias_act_plain(p, w, bias, epilogue=epi, squash_dim=sd,
                                     split_k=split, block_k=bk)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, again)


def test_at_b_ragged_matches_twin_and_repeats_bits_on_the_card(cuda):
    """K6 at a ragged K x N with one split and with several (the M axis
    not a multiple of the split), twice each: identical bits.  Inputs
    are non-negative, so the sums, taken in another order than the
    twin's, do not cancel below the tolerance."""
    for m, k, n in ((333, 150, 70), (5000, 81, 256)):
        a = _rand(m, m, k, uniform=True, device=cuda)
        b = _rand(m + 1, m, n, uniform=True, device=cuda)
        got = k12.matmul_at_b(a, b)
        torch.testing.assert_close(got, k12.matmul_at_b_plain(a, b),
                                   rtol=1e-5, atol=1e-5)
        assert torch.equal(got, k12.matmul_at_b(a, b))
    assert planner.at_b_plan(5000, 81, 256).splits > 1
    # One split, 128 x 128 tiles for the first 9 rows of tiles and 128 x 64
    # past them (a ragged K): every tile in the twin's order, to the bit.
    a = _rand(7, 200, 2100, uniform=True, device=cuda)
    b = _rand(8, 200, 256, uniform=True, device=cuda)
    for wide_rows in (9 * planner.AT_B_TILE_K, 0, 2100):
        got = torch.empty((2100, 256), device=cuda)
        k12.AT_B(build.ptr(a), build.ptr(b), build.ptr(got), build.ptr(got),
                 200, 2100, 256, 1, 208, wide_rows, build.stream_of(a))
        assert torch.equal(got, k12._at_b_stepped(a, b)), wide_rows


def test_gemm_footprint_model_matches_the_kernels(cuda):
    """The planner's shared-memory model is the bytes K2 and K6 ask for
    at launch, for every build, with and without the staged output."""
    import ctypes
    fn = build._library("conv_im2col").matmul_bias_act_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_int
    for bm in planner.TILE_MN:
        for bn in planner.TILE_MN:
            for bk in planner.TILE_K:
                for stage in (False, True):
                    assert fn(bm, bn, bk, int(stage)) == \
                        planner.gemm_smem_bytes(bm, bk, bn,
                                                stage_output=stage)
    at_b = build._library("conv_bwd").matmul_at_b_smem_bytes
    at_b.restype = ctypes.c_int
    assert at_b() == planner.AT_B_SMEM_BYTES


@pytest.mark.parametrize("pipeline", [True, False])
def test_forward_on_the_card_matches_the_plain_forward(cuda, pipeline):
    cfg = capsnet_mnist.smoke_config()
    params = capsnet.init_params(torch.Generator().manual_seed(0), cfg,
                                 device=cuda)
    images = _rand(6, 4, cfg.image_hw, cfg.image_hw, 1, uniform=True,
                   device=cuda)
    plan = execplan.compile_plan(cfg, batch=4, pipeline=pipeline)
    build.reset_launch_counts()
    got = capsnet.forward(params, images, cfg, backend="kernels", plan=plan,
                          device=cuda)
    routed = ("primary_routing_f32" if pipeline
              else "votes_routing_cluster_f32")
    assert build.launch_counts()[routed] == 1
    want = capsnet.forward(params, images, cfg, backend="torch", device=cuda)
    for k in ("class_caps", "lengths", "reconstruction"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-5)


def test_engine_serves_on_the_card(cuda):
    cfg = capsnet_mnist.smoke_config()
    params = capsnet.init_params(torch.Generator().manual_seed(0), cfg,
                                 device=cuda)
    imgs = np.random.default_rng(7).random(
        (5, cfg.image_hw, cfg.image_hw, 1), np.float32)
    engine = CapsuleEngine(params, cfg, slots=2, device=cuda)
    for i, img in enumerate(imgs):
        engine.submit(CapsRequest(rid=i, image=img))
    done = engine.run()
    want = capsnet.forward(params, imgs, cfg, backend="torch",
                           device=cuda)["lengths"].cpu().numpy()
    assert [r.status for r in done] == ["ok"] * 5
    for r in done:
        np.testing.assert_allclose(r.lengths, want[r.rid], rtol=1e-5,
                                   atol=1e-5)


def test_engine_raises_a_refused_launch_on_the_card(cuda, monkeypatch):
    """A kernel launch the CUDA runtime refuses raises out of step(): the
    breaker takes only a PlanError, so it never serves around a broken
    kernel on the plain path."""
    cfg = capsnet_mnist.smoke_config()
    params = capsnet.init_params(torch.Generator().manual_seed(0), cfg,
                                 device=cuda)
    img = np.random.default_rng(7).random(
        (cfg.image_hw, cfg.image_hw, 1), np.float32)
    engine = CapsuleEngine(params, cfg, slots=2, device=cuda,
                           breaker_after=1)
    engine.submit(CapsRequest(rid=0, image=img))
    monkeypatch.setattr(k12.PATCHES, "_fn", lambda *args: 1)
    with pytest.raises(RuntimeError, match="im2col_patches_f32: CUDA error"):
        engine.step()
    stats = engine.stats()
    assert (stats["forward_failures"], stats["breaker_trips"]) == (0, 0)
    assert engine._backend == "kernels" and not engine.degraded


def test_backward_kernels_launch_and_match_twins_on_the_card(cuda):
    """K6 with one split and with several (ragged M), K7 at two strides,
    K8 and K9 with a ragged i-block, each against its plain twin."""
    build.reset_launch_counts()
    for m, k, n in ((45, 13, 21), (3000, 81, 32)):
        a = _rand(m, m, k, device=cuda)
        b = _rand(m + 1, m, n, device=cuda)
        torch.testing.assert_close(k12.matmul_at_b(a, b),
                                   k12.matmul_at_b_plain(a, b),
                                   rtol=1e-5, atol=1e-5)
    for stride in (1, 2):
        oh = (11 - 3) // stride + 1
        dp = _rand(stride, 2, oh * oh, 3 * 3 * 5, device=cuda)
        kw = dict(kh=3, kw=3, stride=stride, h=11, w=11)
        torch.testing.assert_close(k12.col2im_patches(dp, **kw),
                                   k12.col2im_patches_plain(dp, **kw),
                                   rtol=0, atol=0)
    u = _rand(5, 3, 64, 4, scale=0.5, device=cuda)
    w = _rand(6, 64, 32, 4, scale=0.3, device=cuda)
    g = _rand(7, 3, 32, device=cuda)
    for mode in ("resident", "streamed"):
        kw = dict(iters=3, num_classes=4, mode=mode, block_i=24)
        got = k34.votes_routing_bwd(u, w, g, **kw)
        want = k34.votes_routing_bwd_plain(u, w, g, **kw)
        for x, y in zip(got, want):
            torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-6)
    counts = build.launch_counts()
    for sym in ("matmul_at_b_f32", "col2im_patches_f32",
                "routing_bwd_cluster_f32"):
        assert counts[sym] > 0, sym
    assert counts["routing_bwd_cluster_f32"] == 2     # K8 and K9


def _offset(t: torch.Tensor, floats: int) -> torch.Tensor:
    """A contiguous copy of ``t`` that starts ``floats`` floats into its
    buffer (with 1, 16-byte alignment is lost)."""
    buf = torch.empty(t.numel() + floats, dtype=t.dtype, device=t.device)
    view = buf[floats:].view(t.shape)
    view.copy_(t)
    return view


# A profiler session can lose the kernel records at its start (an empty
# trace of a short call, most often in a process that has just built the
# kernels), so a traced call runs between marker kernels: TRACE_LEAD
# ``frac_`` and a device spin of TRACE_SPIN_CYCLES take that loss, then
# TRACE_GUARD ``trunc_`` before the call and ``floor_`` after it show
# whether its records are all there.
TRACE_LEAD, TRACE_SPIN_CYCLES, TRACE_GUARD = 64, 10_000_000, 8
TRACE_MARKERS = ("frac_kernel", "trunc_kernel", "floor_kernel")


def _kernel_names(fn, tries: int = 3) -> set[str]:
    """The CUDA kernels one call of ``fn`` launches, by profiler name,
    from the first of ``tries`` traces that holds every guard on both
    sides of the call (the last trace's if none does)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    mark = torch.ones(1, device="cuda")
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(TRACE_LEAD):
                mark.frac_()
            torch.cuda._sleep(TRACE_SPIN_CYCLES)
            for _ in range(TRACE_GUARD):
                mark.trunc_()
            fn()
            for _ in range(TRACE_GUARD):
                mark.floor_()
            torch.cuda.synchronize()
        records = {e.key: e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA}
        guards = [sum(n for k, n in records.items() if part in k)
                  for part in TRACE_MARKERS[1:]]
        if guards == [TRACE_GUARD, TRACE_GUARD]:
            break
    return {k for k in records
            if not any(part in k for part in TRACE_MARKERS)}


# (b, h, w, c, kh, kw, stride): float4 copies (C = 8, 256), the scalar path
# (C = 1, 3, 5), B = 1, H != W, kh != kw, strides 1-3, a stride equal to
# the window (no overlap) and one wider than it (pixels no window covers).
GATHER_CASES = [(2, 20, 20, 8, 9, 9, 2), (1, 11, 13, 256, 3, 3, 2),
                (2, 12, 12, 1, 3, 3, 1), (1, 13, 9, 3, 3, 2, 2),
                (2, 10, 7, 5, 3, 3, 3), (1, 9, 11, 8, 2, 2, 3),
                (1, 8, 10, 4, 3, 3, 1)]


@pytest.mark.parametrize("floats", [0, 1])
@pytest.mark.parametrize("b,h,w,c,kh,kw,stride", GATHER_CASES)
def test_im2col_col2im_paths_repeat_the_twins_bits(cuda, b, h, w, c, kh,
                                                    kw, stride, floats):
    """K1 and K7 on each of their paths give the plain twins' bits, on a
    second launch too, and are adjoint: <K1(x), dp> = <x, K7(dp)>.  A
    tensor that starts one float into its buffer takes the scalar path."""
    x = _offset(_rand(b, b, h, w, c, device=cuda), floats)
    oh, ow = k12.out_size(h, kh, stride), k12.out_size(w, kw, stride)
    dp = _offset(_rand(c, b, oh * ow, kh * kw * c, device=cuda), floats)
    kw_ = dict(kh=kh, kw=kw, stride=stride)
    build.reset_launch_counts()
    p = k12.im2col_patches(x, **kw_)
    dx = k12.col2im_patches(dp, h=h, w=w, **kw_)
    assert torch.equal(p, k12.im2col_patches_plain(x, **kw_))
    assert torch.equal(dx, k12.col2im_patches_plain(dp, h=h, w=w, **kw_))
    assert torch.equal(p, k12.im2col_patches(x, **kw_))
    assert torch.equal(dx, k12.col2im_patches(dp, h=h, w=w, **kw_))
    counts = build.launch_counts()
    assert counts["im2col_patches_f32"] == counts["col2im_patches_f32"] == 2
    # dx holds fp32 sums of at most ceil(kh/s) * ceil(kw/s) taps: each
    # within a few ulps, so the two sides agree to ~1e-7 of sum |p dp|.
    terms = p.double() * dp.double()
    rhs = (x.double() * dx.double()).sum()
    assert abs(terms.sum() - rhs) <= 1e-6 * terms.abs().sum()
    vec = c % 4 == 0 and floats == 0
    names = _kernel_names(lambda: (k12.im2col_patches(x, **kw_),
                                   k12.col2im_patches(dp, h=h, w=w, **kw_)))
    for kernel in ("im2col_kernel", "col2im_kernel"):
        launched = [n for n in names if kernel in n]
        assert len(launched) == 1, names
        assert ("float4" in launched[0]) == vec, launched


def test_im2col_col2im_empty_batch_launches_nothing(cuda):
    build.reset_launch_counts()
    x = torch.empty(0, 9, 9, 4, device=cuda)
    assert k12.im2col_patches(x, kh=3, kw=3).shape == (0, 49, 36)
    dp = torch.empty(0, 49, 36, device=cuda)
    assert k12.col2im_patches(dp, kh=3, kw=3, stride=1, h=9,
                              w=9).shape == (0, 9, 9, 4)
    counts = build.launch_counts()
    assert counts["im2col_patches_f32"] == counts["col2im_patches_f32"] == 0


@pytest.mark.parametrize("pipeline", [True, False])
def test_total_loss_backward_on_the_card_matches_the_plain_backend(
        cuda, pipeline):
    """Every parameter gets a gradient through the kernels, equal to the
    plain backend's autograd gradient."""
    cfg = capsnet_mnist.smoke_config()
    params = capsnet.init_params(torch.Generator().manual_seed(0), cfg,
                                 device=cuda)
    images = _rand(8, 4, cfg.image_hw, cfg.image_hw, 1, uniform=True,
                   device=cuda)
    labels = torch.tensor([1, 5, 0, 9], device=cuda)
    plan = execplan.compile_plan(cfg, batch=4, pipeline=pipeline, train=True)
    build.reset_launch_counts()
    got, _ = capsnet.loss_and_grads(params, images, labels, cfg,
                                    backend="kernels", plan=plan,
                                    device=cuda)
    counts = build.launch_counts()
    want, _ = capsnet.loss_and_grads(params, images, labels, cfg,
                                     backend="torch", device=cuda)
    for sym in ("matmul_at_b_f32", "col2im_patches_f32",
                "routing_bwd_cluster_f32"):
        assert counts[sym] > 0, sym
    for k in params:
        scale = want[k].abs().max().clamp_min(1e-12)
        assert ((got[k] - want[k]).abs().max() / scale).item() < 1e-4, k


def _at_odd_offset(t):
    """A contiguous copy of t whose data starts 4 bytes past a 16-byte
    boundary: the kernels' scalar loads."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def test_split_path_and_squash_launch_and_match_twins_on_the_card(cuda):
    """K14a at C = 8 (compiled for) and 16 and 5 (any C; each bit for bit
    with its twin's fmaf chain), a ragged I, batches 1 to 130 (u staged in three chunks
    of samples), i-blocks from 1 row to past I and inputs
    off 16-byte alignment; K14b with ragged u_hat tiles; K10 forward and
    backward at D = 5, 8, 160, 256 and past 1024 with ragged rows, every
    lane count (the loop past eight chunks a lane) and misaligned rows,
    each against its plain twin; the split path against the fused
    kernel."""
    build.reset_launch_counts()
    for seed, (bsz, i, c, n) in enumerate(((3, 300, 8, 40),
                                           (1, 1152, 8, 160),
                                           (64, 131, 8, 160),
                                           (130, 67, 8, 40),
                                           (2, 50, 16, 40), (4, 77, 5, 24))):
        u = _rand(10 + seed, bsz, i, c, scale=0.5, device=cuda)
        w = _rand(20 + seed, i, n, c, scale=0.3, device=cuda)
        for bi in sorted({1, 7, ops.planned_block_i(i, c, n, bsz), 128,
                          i + 5}):
            if execplan.caps_votes_smem(bsz, min(bi, i), c) \
                    > planner.SMEM_BYTES:
                continue
            for uu, ww in ((u, w), (_at_odd_offset(u), _at_odd_offset(w))):
                assert torch.equal(
                    k14a.caps_votes(uu, ww, block_i=bi),
                    k14a.caps_votes_plain(uu, ww, block_i=bi)), (bsz, i, c,
                                                                 bi)
    u = _rand(10, 3, 300, 8, scale=0.5, device=cuda)
    w = _rand(11, 300, 40, 8, scale=0.3, device=cuda)
    uh = _rand(12, 3, 300, 40, scale=0.1, device=cuda)
    for bi, cs in ((1, 16), (64, 2), (300, 1), (7, 4)):
        for mode in ("resident", "streamed"):
            kw = dict(iters=3, num_classes=4, mode=mode, block_i=bi,
                      cluster=cs)
            torch.testing.assert_close(k14b.routing(uh, **kw),
                                       k14b.routing_plain(uh, **kw),
                                       rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(
        ops.routing(ops.caps_votes(u, w), iters=3, num_classes=4),
        ops.votes_routing(u, w, iters=3, num_classes=4),
        rtol=1e-5, atol=1e-6)
    for shape in ((37, 8), (1001, 8), (13, 5), (9, 160), (130, 160),
                  (4, 33), (301, 256), (5, 1100)):
        x = _rand(13, *shape, device=cuda)
        g = _rand(14, *shape, device=cuda)
        planned = execplan.squash_block_rows(shape[1], shape[0])
        for br in sorted({planned, 3, 16}):
            for lanes in (None, 1, 4, 32):
                for xx, gg in ((x, g), (_at_odd_offset(x),
                                        _at_odd_offset(g))):
                    kw = dict(block_rows=br, lanes=lanes)
                    torch.testing.assert_close(
                        k10.squash_rows(xx, **kw), k10.squash_plain(xx),
                        rtol=1e-5, atol=1e-6)
                    torch.testing.assert_close(
                        k10.squash_bwd(xx, gg, **kw),
                        k10.squash_bwd_plain(xx, gg), rtol=1e-5, atol=1e-6)
    counts = build.launch_counts()
    for sym in ("caps_votes_f32", "routing_cluster_f32", "squash_f32",
                "squash_bwd_f32"):
        assert counts[sym] > 0, sym


def test_unfusable_capsule_forward_and_backward_on_the_card(cuda):
    """A 160-float capsule: the per-op plan runs the plain GEMM, then K10
    forward (and K10 backward in the gradient), equal to the plain
    backend."""
    cfg = capsnet.CapsNetConfig(
        image_hw=14, conv1_channels=24, conv1_kernel=5, pc_kernel=3,
        num_primary_groups=1, primary_dim=160, class_dim=8,
        decoder_hidden=(32, 64))
    params = capsnet.init_params(torch.Generator().manual_seed(0), cfg,
                                 device=cuda)
    images = _rand(15, 2, 14, 14, 1, uniform=True, device=cuda)
    labels = torch.tensor([3, 7], device=cuda)
    plan = execplan.compile_plan(cfg, batch=2, pipeline=False, train=True)
    assert not plan.op("PrimaryCaps").fuses_squash
    build.reset_launch_counts()
    got, _ = capsnet.loss_and_grads(params, images, labels, cfg,
                                    backend="kernels", plan=plan,
                                    device=cuda)
    counts = build.launch_counts()
    want, _ = capsnet.loss_and_grads(params, images, labels, cfg,
                                     backend="torch", device=cuda)
    assert counts["squash_f32"] == 1 and counts["squash_bwd_f32"] == 1
    for k in params:
        scale = want[k].abs().max().clamp_min(1e-12)
        assert ((got[k] - want[k]).abs().max() / scale).item() < 1e-4, k


def test_deep_stack_kernels_launch_and_match_twins_on_the_card(cuda):
    """The residual epilogue on every schedule, the streamed-global mode
    (logits in device memory; its backward is K9's streamed cluster) and
    K13, forward and backward, each against its plain twin; K13 equals K4
    and K9 on the same cluster bit for bit, with its logits in shared
    memory and, where K4's share of them fits no CTA, in device memory."""
    build.reset_launch_counts()
    u = _rand(16, 3, 70, 4, scale=0.5, device=cuda)
    w = _rand(17, 70, 32, 4, scale=0.3, device=cuda)
    r = _rand(18, 3, 32, device=cuda)
    g = _rand(19, 3, 32, device=cuda)
    for mode in execplan.ALL_MODES:
        kw = dict(iters=3, num_classes=4, mode=mode, block_i=24)
        for rr in (None, r):
            torch.testing.assert_close(
                k34.votes_routing(u, w, r=rr, **kw),
                _fwd_twin(u, w, rr, **kw), rtol=1e-5, atol=1e-6)
        got = k34.votes_routing_bwd(u, w, g, **kw)
        want = k34.votes_routing_bwd_plain(u, w, g, **kw)
        for x, y in zip(got, want):
            torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-6)
    oracle = execplan.ORACLE_MODE
    kw = dict(iters=3, num_classes=4, block_i=24)
    cs = k34.fwd_cluster(u, w, mode=oracle, cluster=None, **kw)
    assert torch.equal(
        k34.votes_routing(u, w, r=r, mode=oracle, cluster=cs, **kw),
        k34.votes_routing(u, w, r=r, mode="streamed", cluster=cs, **kw))
    _, bcs = k34.bwd_schedule(u, w, iters=3, num_classes=4, mode=oracle,
                              cluster=None)
    for x, y in zip(
            k34.votes_routing_bwd(u, w, g, mode=oracle, cluster=bcs, **kw),
            k34.votes_routing_bwd(u, w, g, mode="streamed", cluster=bcs,
                                  **kw)):
        assert torch.equal(x, y)
    # On one CTA a sample the bottleneck's logits (2048 x 64) fit no CTA:
    # K13 keeps them in device memory there, as K4g does.
    ub = _rand(20, 2, 2048, 8, scale=0.5, device=cuda)
    wb = _rand(21, 2048, 512, 8, scale=0.1, device=cuda)
    kw = dict(iters=3, num_classes=64, block_i=64, cluster=1)
    assert k34.logits_placement(oracle, 2048, 8, 64, 512, 1, 64) \
        == execplan.STREAMED_GLOBAL
    assert torch.equal(
        k34.votes_routing(ub, wb, mode=oracle, **kw),
        k34.votes_routing(ub, wb, mode=execplan.STREAMED_GLOBAL, **kw))
    counts = build.launch_counts()
    for sym in ("votes_routing_streamed_cluster_f32",
                "votes_routing_global_cluster_f32",
                "votes_routing_2pass_f32", "routing_bwd_cluster_f32",
                "routing_bwd_2pass_f32"):
        assert counts[sym] > 0, sym


@pytest.mark.parametrize("module", [capsnet_svhn, capsnet_cifar10])
def test_deep_stack_forward_and_backward_on_the_card(cuda, module):
    """A ResCaps stack through the reversible segment (K12): forward and
    every gradient equal to the plain backend."""
    cfg = module.smoke_config()
    params = capsnet.init_params(torch.Generator().manual_seed(0), cfg,
                                 device=cuda)
    images = _rand(22, 4, cfg.image_hw, cfg.image_hw, 3, uniform=True,
                   device=cuda)
    labels = torch.tensor([2, 4, 6, 8], device=cuda)
    plan = execplan.compile_plan(cfg, batch=4, train=True)
    with torch.no_grad():
        got = capsnet.forward(params, images, cfg, backend="kernels",
                              plan=plan, device=cuda)
        want = capsnet.forward(params, images, cfg, backend="torch",
                               device=cuda)
    for k in ("class_caps", "lengths", "reconstruction"):
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-5)
    build.reset_launch_counts()
    got, _ = capsnet.loss_and_grads(params, images, labels, cfg,
                                    backend="kernels", plan=plan,
                                    device=cuda)
    counts = build.launch_counts()
    want, _ = capsnet.loss_and_grads(params, images, labels, cfg,
                                     backend="torch", device=cuda)
    # K8 on clusters: at least each ResCaps half's and ClassCaps' backward.
    assert counts["routing_bwd_cluster_f32"] >= 5
    for k in params:
        scale = want[k].abs().max().clamp_min(1e-12)
        assert ((got[k] - want[k]).abs().max() / scale).item() < 1e-4, k


# ---------------------------------------------------------------------------
# LM side: K15 flash attention and K16 RMSNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(7, 384), (33, 3584), (4, 8192)])
def test_rmsnorm_kernel_matches_twin_on_the_card(cuda, rows, d, dtype):
    from repro_torch.kernels import rmsnorm as k16
    x = _rand(1, rows, d, device=cuda).to(dtype)
    w = _rand(2, d, scale=0.1, device=cuda)
    k16.RMSNORM.launches = 0
    got = ops.rmsnorm(x, w)
    assert k16.RMSNORM.launches == 1 and got.dtype == dtype
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(),
                               k16.rmsnorm_plain(x, w).float(), rtol=tol,
                               atol=tol)
    # An unaligned row start takes the scalar path.
    xs = x.reshape(-1)[1:1 + (rows - 1) * d].reshape(rows - 1, d)
    torch.testing.assert_close(ops.rmsnorm(xs, w).float(),
                               k16.rmsnorm_plain(xs, w).float(), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("threads", [None, 512, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [1, 4, 8, 33, 4608])
def test_rmsnorm_small_rows_form_matches_twin_on_the_card(cuda, rows, dtype,
                                                          threads):
    """K16's CTA-a-row form (every load before the sum) at gemma2's
    D = 3584, decode's rows and prefill's: the planned CTA size and each
    of the others, the 16-byte path and an unaligned row start (the
    element-wise path); the warp-a-row form refuses the row."""
    from repro_torch.kernels import rmsnorm as k16
    d = 3584
    x = _rand(3, rows, d, device=cuda).to(dtype)
    w = _rand(4, d, scale=0.1, device=cuda)
    tol = 2e-5 if dtype == torch.float32 else 2e-2

    def run(xx):
        return (k16.rmsnorm(xx, w) if threads is None
                else k16.rmsnorm_form(xx, w, threads))
    run(x)
    names: set[str] = set()
    for _ in range(3):          # the trace can come back empty; look again
        names |= _kernel_names(lambda: run(x))
        if names:
            break
    assert any("rmsnorm_row_kernel" in n for n in names), names
    assert k16.plan(d, 16 // x.element_size()) in k16.CTA_THREADS
    for xx in (x, _offset(x, 1)):
        torch.testing.assert_close(run(xx).float(),
                                   k16.rmsnorm_plain(xx, w).float(),
                                   rtol=tol, atol=tol)
    with pytest.raises(ValueError, match="cannot hold"):
        k16.rmsnorm_form(x, w, k16.WARP_ROWS)


@pytest.mark.parametrize("block_k", [None, 32, 64])
@pytest.mark.parametrize("d", [16, 64, 128, 256])
@pytest.mark.parametrize("case", ["prefill", "ragged", "window", "decode",
                                  "no_key_rows", "bidir", "bf16_cache",
                                  "bf16_model", "kv_len_past_tk",
                                  "kv_len_zero", "decode_tq1_g4",
                                  "decode_tq3_g2", "decode_tq3_g4",
                                  "decode_long_cache"])
def test_flash_kernel_matches_twin_on_the_card(cuda, d, case, block_k):
    """Each case on the planned schedule (block_k None: decode where the
    rows a KV head are few, else prefill) and on both prefill tiles; a
    tile that does not fit a CTA at this head dim is refused by name."""
    from repro_torch.kernels import flash_attention as k15
    b, h, kvh = 2, 4, 2
    tq, tk, kw, lens = {
        "prefill": (128, 128, dict(softcap=50.0), None),
        "ragged": (75, 75, dict(), None),
        "window": (150, 150, dict(window=40, softcap=30.0), None),
        "decode": (1, 300, dict(window=100), [300, 17]),
        "no_key_rows": (40, 24, dict(), None),
        "bidir": (33, 70, dict(causal=False, window=9), None),
        "bf16_cache": (3, 90, dict(), [90, 50]),
        "bf16_model": (70, 70, dict(softcap=50.0), None),
        # kv_len is clamped to 0..Tk: no read past K/V, an empty row is 0.
        "kv_len_past_tk": (4, 60, dict(window=20), [500, 33]),
        "kv_len_zero": (5, 60, dict(), [0, 60]),
        "decode_tq1_g4": (1, 200, dict(softcap=50.0), [200, 3]),
        "decode_tq3_g2": (3, 130, dict(window=16, softcap=50.0), [2, 129]),
        "decode_tq3_g4": (3, 97, dict(), [97, 40]),
        # 4608 keys in planned splits, most of them past both rows'
        # kv_len (empty partials) or, under the window, before it.
        "decode_long_cache": (1, 4608, dict(window=1024, softcap=50.0),
                              [3000, 40]),
    }[case]
    if case.endswith("_g4"):
        h = 8
    q = _rand(3, b, tq, h, d, device=cuda)
    k = _rand(4, b, tk, kvh, d, device=cuda)
    v = _rand(5, b, tk, kvh, d, device=cuda)
    if case == "bf16_cache":
        k, v = k.bfloat16(), v.bfloat16()
    tol = 2e-5
    if case == "bf16_model":            # the output rounds to bf16 once
        q, k, v, tol = q.bfloat16(), k.bfloat16(), v.bfloat16(), 2e-2
    kv_len = (torch.tensor(lens, dtype=torch.int32, device=cuda)
              if lens else None)
    if block_k is not None and k15.smem_bytes(
            d, block_k, k.element_size()) > planner.SMEM_BYTES:
        with pytest.raises(ValueError, match=f"block_k {block_k}"):
            k15.flash_attention(q, k, v, kv_len=kv_len, block_k=block_k,
                                **kw)
        return
    rows = tq * h // kvh
    if case.startswith("decode") and block_k is None:
        assert (k15.plan_decode(b, kvh, rows, tk, d) is not None) == (
            rows <= k15.decode_rows(d))
    k15.FLASH.launches = 0
    got = k15.flash_attention(q, k, v, kv_len=kv_len, block_k=block_k, **kw)
    assert k15.FLASH.launches == 1
    want = k15.flash_attention_plain(q, k, v, kv_len=kv_len, **kw)
    assert got.dtype == q.dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_schedules_repeat_their_bits_and_decode_matches_its_twin(
        cuda, d):
    """A second launch gives the same bits in both schedules (the decode
    splits merge in split order, no atomics), and the decode kernel
    agrees with ``flash_decode_plain`` at the planned split count and at
    others, with empty splits, window-only splits and mean-of-V rows;
    both schedules also read K/V whose rows are not 16-byte aligned."""
    from repro_torch.kernels import flash_attention as k15
    b, h, kvh, tk = 4, 4, 2, 700
    kw = dict(window=200, softcap=50.0)
    lens = torch.tensor([700, 450, 17, 0], dtype=torch.int32, device=cuda)
    qd = _rand(6, b, 1, h, d, device=cuda)
    qp = _rand(7, 1, 150, h, d, device=cuda)
    k = _rand(8, b, tk, kvh, d, device=cuda)
    v = _rand(9, b, tk, kvh, d, device=cuda)
    planned = k15.plan_decode(b, kvh, h // kvh, tk, d)
    assert planned is not None
    for fn in (lambda: k15.flash_attention(qd, k, v, kv_len=lens, **kw),
               lambda: k15.flash_attention(qp, k[:1, :150], v[:1, :150],
                                           **kw)):
        first, second = fn(), fn()
        assert torch.equal(first, second)
    for splits in (planned, 1, 3, 64):
        got = k15.flash_attention(qd, k, v, kv_len=lens, splits=splits, **kw)
        want = k15.flash_decode_plain(qd, k, v, kv_len=lens, splits=splits,
                                      **kw)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
        assert torch.equal(got[3], torch.zeros_like(got[3]))
    # K/V rows that start off 16-byte boundaries (a view one element into
    # its storage) take both kernels' element-copy path.
    kbuf = _rand(11, b * tk * kvh * d + 1, device=cuda)
    ku = kbuf[1:].view(b, tk, kvh, d)
    for kw2 in (dict(kv_len=lens), dict(block_k=32)):
        got = k15.flash_attention(qd, ku, ku, **kw, **kw2)
        want = k15.flash_attention_plain(qd, ku, ku, kv_len=kw2.get(
            "kv_len"), **kw)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    # Tq = 3 > kv_len = 2 under causal: row 0 is the mean of V.
    q3 = _rand(10, 1, 3, h, d, device=cuda)
    two = torch.tensor([2], dtype=torch.int32, device=cuda)
    got = k15.flash_attention(q3, k[:1], v[:1], kv_len=two, splits=5)
    want = k15.flash_decode_plain(q3, k[:1], v[:1], kv_len=two, splits=5)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(got[0, 0], v[0, :2].mean(0).repeat_interleave(
        h // kvh, 0), rtol=2e-5, atol=2e-5)


def test_flash_footprint_model_matches_the_kernel(cuda):
    """The planner's shared-memory models are the bytes the kernels ask
    for at launch: every prefill tile and every decode row count the
    library is built for, with fp32 and bf16 K/V."""
    import ctypes

    from repro_torch.kernels import flash_attention as k15
    lib = build._library("flash_attention")
    pre, dec = lib.flash_attention_smem_bytes, lib.flash_decode_smem_bytes
    for fn in (pre, dec):
        fn.argtypes, fn.restype = [ctypes.c_int] * 3, ctypes.c_int
    for d in k15.HEAD_DIMS:
        for kvb in (4, 2):
            for bk in k15.BLOCK_K_CHOICES:
                assert pre(d, bk, kvb) == k15.smem_bytes(d, bk, kvb)
            for rb in k15.DECODE_ROW_BUCKETS:
                if rb <= k15.decode_rows(d):
                    assert dec(d, rb, kvb) == k15.decode_smem_bytes(d, rb,
                                                                    kvb)


def test_lm_kernels_refuse_grad_on_the_card(cuda):
    x = torch.zeros(1, 4, 2, 16, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.rmsnorm(x, torch.zeros(16, device=cuda))
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(x, x, x)


def test_gemma2_smoke_forward_and_engine_on_the_card(cuda):
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = registry.get_smoke_config("gemma2-9b")
    params = T.init_model(torch.Generator(device=cuda).manual_seed(0), cfg,
                          device=cuda)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 21))
    build.reset_launch_counts()
    with torch.no_grad():
        got, _, _ = T.forward(params, toks, cfg=cfg, backend="kernels")
        want, _, _ = T.forward(params, toks, cfg=cfg, backend="torch")
    counts = build.launch_counts()
    assert counts["flash_attention"] == cfg.num_layers
    assert counts["rmsnorm"] == 4 * cfg.num_layers + 1
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    with torch.no_grad():                   # fp32 q reading a bf16 cache
        got, _ = T.prefill(params, toks, cfg, 32, backend="kernels")
        want, _ = T.prefill(params, toks, cfg, 32, backend="torch")
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    outs = {}
    for backend in ("kernels", "torch"):
        eng = ServeEngine(params, cfg, slots=2, max_len=40, backend=backend,
                          device=cuda)
        for i, n in enumerate((12, 3, 20)):
            eng.submit(Request(rid=i, prompt=toks[0, :n].astype(np.int32),
                               max_new_tokens=5))
        outs[backend] = [(r.rid, r.output) for r in eng.run()]
    assert outs["kernels"] == outs["torch"]


def _gemma2_smoke(cuda):
    from repro_torch.configs import registry
    from repro_torch.models import transformer as T
    cfg = registry.get_smoke_config("gemma2-9b")
    return cfg, T.init_model(torch.Generator(device=cuda).manual_seed(0),
                             cfg, device=cuda)


def test_graph_engine_replays_the_eager_engines_ticks_on_the_card(cuda):
    """The engine's decode tick as a CUDA graph: the same tokens, finish
    order and logits, bit for bit, as the eager tick, with slots refilled
    between replays.  The wrappers count 4 norms a layer and the final
    one, one K15 a layer, in every eager forward and in the capture; a
    replay counts nothing and the engine counts the replays."""
    from repro_torch.kernels import flash_attention as k15
    from repro_torch.serve.engine import Request, ServeEngine
    cfg, params = _gemma2_smoke(cuda)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (12, 3, 20, 7, 15)]
    runs = {}
    for graph in (True, False):
        seen = []

        def sampler(lg, seen=seen):
            seen.append(lg.copy())
            return np.argmax(lg, -1)
        eng = ServeEngine(params, cfg, slots=2, max_len=40, backend="kernels",
                          device=cuda, sampler=sampler, cuda_graph=graph)
        for i, p in enumerate(prompts):
            eng.submit(Request(rid=i, prompt=p, max_new_tokens=4 + i))
        build.reset_launch_counts()
        k15.SCHEDULE_LAUNCHES.update(prefill=0, decode=0)
        done = [(r.rid, r.output) for r in eng.run()]
        runs[graph] = dict(eng=eng, done=done, seen=seen,
                           counts=build.launch_counts(),
                           schedules=dict(k15.SCHEDULE_LAUNCHES))
    g, e = runs[True], runs[False]
    assert g["done"] == e["done"]
    assert len(g["seen"]) == len(e["seen"])
    for a, b in zip(g["seen"], e["seen"]):
        np.testing.assert_array_equal(a, b)
    ticks = g["eng"].ticks
    assert g["eng"].tick_kinds == {"eager": 1, "capture": 1,
                                   "replay": ticks - 2}
    assert g["eng"].graph_replays == ticks - 1
    assert e["eng"].tick_kinds == {"eager": e["eng"].ticks}
    assert e["eng"].graph_replays == 0
    for run, ticks_counted in ((g, 2), (e, e["eng"].ticks)):
        n_fwd = len(run["eng"].timings["prefill_s"]) + ticks_counted
        assert run["counts"]["rmsnorm"] == (4 * cfg.num_layers + 1) * n_fwd
        assert run["counts"]["flash_attention"] == cfg.num_layers * n_fwd
        assert sum(run["schedules"].values()) == cfg.num_layers * n_fwd
    assert g["schedules"]["prefill"] == e["schedules"]["prefill"]
    assert e["schedules"]["decode"] - g["schedules"]["decode"] == (
        cfg.num_layers * (e["eng"].ticks - 2))   # the replays


def test_graph_engine_ticks_eagerly_under_fault_injection(cuda):
    """A tick under an injected fault runs eagerly, so the wrapper's site
    fires and the fault reaches the logits; the next tick replays."""
    from repro_torch.core import faults
    from repro_torch.serve.engine import Request, ServeEngine
    cfg, params = _gemma2_smoke(cuda)
    eng = ServeEngine(params, cfg, slots=1, max_len=40, backend="kernels",
                      device=cuda)
    prompt = np.random.default_rng(6).integers(0, cfg.vocab_size, 9)
    eng.submit(Request(rid=0, prompt=prompt.astype(np.int32),
                       max_new_tokens=10))
    for _ in range(3):
        eng.step()
    assert eng.tick_kinds == {"eager": 1, "capture": 1, "replay": 1}
    before = build.launch_counts()["rmsnorm"]
    eng.step()
    assert eng.last_tick == "replay" and eng.graph_replays == 3
    assert build.launch_counts()["rmsnorm"] == before
    assert torch.isfinite(eng._logits).all()
    spec = faults.FaultSpec(site=faults.SITE_RMSNORM, kind="nan_output",
                            times=10 ** 6)
    with faults.inject(spec) as reg:
        eng.step()
    assert eng.last_tick == "eager" and reg.count() > 0
    assert build.launch_counts()["rmsnorm"] - before == (
        4 * cfg.num_layers + 1)
    assert torch.isnan(eng._logits).all()
    eng.step()
    assert eng.last_tick == "replay" and eng.graph_replays == 4
