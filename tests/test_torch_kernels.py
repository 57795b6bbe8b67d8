"""The port's kernel modules against the reference's Pallas kernels.

Inputs are made with numpy from a seed and go through both: the
reference's wrappers in interpret mode (as tests/test_conv_kernels.py and
tests/test_votes_routing.py run them) and the port's wrappers on CPU
tensors, which run the plain PyTorch twins.  Tolerances are the
reference's own: 1e-5 for the conv kernels, rtol 1e-5 / atol 1e-6 for
routing and for every gradient.  The CUDA kernels themselves are held against the same twins on
the card by tests/test_torch_gpu.py (and by ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels.conv_im2col import col2im_patches as ref_col2im
from repro.kernels.conv_im2col import conv2d_im2col as ref_conv
from repro.kernels.conv_im2col import im2col_patches as ref_patches
from repro.kernels.conv_im2col import matmul_at_b as ref_at_b
from repro.kernels.conv_im2col import matmul_bias_act as ref_matmul
from repro.kernels.primary_routing import primary_caps_routing
from repro_torch.core import capsnet as T
from repro_torch.core import planner
from repro_torch.kernels import build
from repro_torch.kernels import conv_im2col as k12
from repro_torch.kernels import primary_routing as k5
from repro_torch.kernels import votes_routing as k34


def _rand(seed, *shape, scale=1.0, uniform=False):
    rng = np.random.default_rng(seed)
    x = rng.random(shape) if uniform else rng.standard_normal(shape)
    return (scale * x).astype(np.float32)


@pytest.mark.parametrize("b,hw,c,k,stride", [
    (2, 11, 3, 3, 1),
    (2, 14, 5, 5, 2),          # strided
    (1, 9, 2, 4, 3),           # stride wider than the overlap
])
def test_im2col_patches_matches_reference(b, hw, c, k, stride):
    x = _rand(hw, b, hw, hw, c, uniform=True)
    want = ref_patches(jnp.asarray(x), kh=k, kw=k, stride=stride)
    got = k12.im2col_patches(torch.from_numpy(x), kh=k, kw=k, stride=stride)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("epilogue,sd", [("none", 0), ("relu", 0),
                                         ("squash", 4)])
@pytest.mark.parametrize("m,k,n,split_k", [
    (37, 75, 24, 1), (16, 8, 8, 1),
    (37, 75, 24, 2),           # K = 75 cut into slabs of 48: 48 + 27
    (37, 75, 24, 3),           # slabs of 32: 32 + 32 + 11
], ids=["37-75-24", "16-8-8", "37-75-24-split2", "37-75-24-split3"])
def test_matmul_bias_act_matches_reference(epilogue, sd, m, k, n, split_k):
    """Ragged M/N tiles and a K that is not a multiple of block_k nor of
    the split's slab; the split twin sums its partials in K2's order."""
    p = _rand(m, m, k, uniform=True)
    w = _rand(k, k, n, scale=0.3)
    bias = _rand(n, n, scale=0.1)
    want = ref_matmul(jnp.asarray(p), jnp.asarray(w), jnp.asarray(bias),
                      block_m=8, block_k=16, block_n=8, epilogue=epilogue,
                      squash_dim=sd)
    args = (torch.from_numpy(p), torch.from_numpy(w), torch.from_numpy(bias))
    got = k12.matmul_bias_act(*args, block_m=64, block_k=16, block_n=8,
                              epilogue=epilogue, squash_dim=sd,
                              split_k=split_k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    plain = k12.matmul_bias_act_plain(*args, epilogue=epilogue,
                                      squash_dim=sd, split_k=split_k,
                                      block_k=16)
    assert torch.equal(got, plain)
    assert planner.split_slab(k, split_k, 16)[0] == split_k


def test_matmul_squash_rejects_misaligned_tile():
    p, w, b = torch.ones(4, 6), torch.ones(6, 12), torch.zeros(12)
    with pytest.raises(ValueError, match="capsule dim"):
        k12.matmul_bias_act(p, w, b, block_n=8, epilogue="squash",
                            squash_dim=5)
    with pytest.raises(ValueError, match="unknown epilogue"):
        k12.matmul_bias_act(p, w, b, epilogue="gelu")


@pytest.mark.parametrize("mode", ["resident", "streamed"])
@pytest.mark.parametrize("b,i,c,j,d,bi", [
    (2, 100, 8, 10, 16, 32),      # ragged final i-block: zero padding
    (2, 27, 4, 4, 8, 8),          # odd capsule count
])
def test_votes_routing_matches_reference(mode, b, i, c, j, d, bi):
    u = _rand(i, b, i, c, scale=0.5)
    w = _rand(i + 1, i, j * d, c, scale=0.3)
    want = rops.votes_routing(jnp.asarray(u), jnp.asarray(w), iters=3,
                              num_classes=j, mode=mode, block_i=bi)
    got = k34.votes_routing(torch.from_numpy(u), torch.from_numpy(w),
                            iters=3, num_classes=j, mode=mode, block_i=bi)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_votes_routing_rejects_bad_schedule():
    u, w = torch.zeros(1, 16, 4), torch.zeros(16, 20, 4)
    with pytest.raises(ValueError, match="unknown mode"):
        k34.votes_routing(u, w, num_classes=5, mode="hybrid", block_i=8)
    with pytest.raises(ValueError, match="not divisible"):
        k34.votes_routing(u, w, num_classes=3, mode="resident", block_i=8)


@pytest.mark.parametrize("mode", ["resident", "streamed"])
def test_primary_routing_matches_reference(mode):
    """I = 4*4*4 = 64 capsules, block_i 24 (ragged), K = 3*3*8 = 72 with
    block_k 32 (ragged)."""
    b, h, cin, kh, n_ch, c, j, d = 2, 10, 8, 3, 16, 4, 4, 8
    i_dim = 16 * (n_ch // c)
    x = _rand(1, b, h, h, cin, uniform=True)
    w_pc = _rand(2, kh, kh, cin, n_ch, scale=0.2)
    b_pc = _rand(3, n_ch, scale=0.1)
    w_cc = _rand(4, i_dim, j * d, c, scale=0.3)
    want = primary_caps_routing(
        jnp.asarray(x), jnp.asarray(w_pc), jnp.asarray(b_pc),
        jnp.asarray(w_cc), stride=2, iters=3, num_classes=j, mode=mode,
        block_i=24, block_k=32)
    got = k5.primary_routing(
        torch.from_numpy(x), torch.from_numpy(w_pc), torch.from_numpy(b_pc),
        torch.from_numpy(w_cc), stride=2, iters=3, num_classes=j, mode=mode,
        block_i=24)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_primary_routing_rejects_mismatched_capsules():
    x = torch.zeros(1, 10, 10, 8)
    with pytest.raises(ValueError, match="capsules"):
        k5.primary_routing(x, torch.zeros(3, 3, 8, 16), torch.zeros(16),
                           torch.zeros(60, 32, 4), num_classes=4)


def test_wrappers_raise_on_mixed_devices():
    meta = torch.empty(2, 8, 8, 1, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        k12.im2col_patches(meta, kh=3, kw=3)


def test_every_kernel_has_a_launch_counter():
    from repro_torch.kernels import ops  # noqa: F401  (imports every module)
    assert set(build.REGISTRY) == {"im2col_patches_f32",
                                   "matmul_bias_act_f32",
                                   "votes_routing_streamed_cluster_f32",
                                   "primary_routing_f32",
                                   "votes_routing_global_cluster_f32",
                                   "votes_routing_2pass_f32",
                                   "votes_routing_cluster_f32",
                                   "matmul_at_b_f32", "col2im_patches_f32",
                                   "routing_bwd_2pass_f32",
                                   "routing_bwd_cluster_f32",
                                   "routing_bwd_global_cluster_f32",
                                   "caps_votes_f32", "routing_cluster_f32",
                                   "squash_f32", "squash_bwd_f32",
                                   "rmsnorm", "flash_attention"}
    assert {k.library for k in build.REGISTRY.values()} == set(
        build.LIBRARIES)
    assert all(isinstance(n, int) for n in build.launch_counts().values())


# ---------------------------------------------------------------------------
# Backward kernels: K6, K7, K8/K9 twins and the autograd Functions
# ---------------------------------------------------------------------------

def _grads_jax(fn, args, argnums):
    return [np.asarray(g) for g in
            jax.grad(fn, argnums=argnums)(*map(jnp.asarray, args))]


@pytest.mark.parametrize("m,k,n", [
    (45, 13, 21),              # M ragged against the reference's block_m
    (3000, 81, 32),            # the port splits M across CTAs
])
def test_matmul_at_b_matches_reference(m, k, n):
    """Non-negative inputs: the 3000-term sums, taken in another order,
    then stay within the reference's tolerance (no cancellation)."""
    a = _rand(m, m, k, uniform=True)
    b = _rand(m + 1, m, n, uniform=True)
    want = ref_at_b(jnp.asarray(a), jnp.asarray(b), block_m=16, block_k=8,
                    block_n=8)
    got = k12.matmul_at_b(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    plan = planner.at_b_plan(m, k, n)
    splits, rows = plan.splits, plan.rows
    assert (splits > 1) == (m > planner.AT_B_MIN_ROWS)
    assert (splits - 1) * rows < m <= splits * rows


@pytest.mark.parametrize("m,k,n", [
    (45, 13, 21), (64, 81, 256), (200, 81, 256), (576, 20736, 256),
    (1024, 20736, 256), (6400, 81, 256), (9216, 243, 256), (3000, 81, 32),
])
def test_at_b_splits_leave_no_split_empty(m, k, n):
    """K6's schedule: split slabs a multiple of the 16-row step, at least
    ``AT_B_MIN_ROWS`` long, none empty; one split covers all of M, its
    wide (128 x 128) rows a whole number of tile rows."""
    plan = planner.at_b_plan(m, k, n)
    assert plan.rows % planner.AT_B_STEP == 0
    assert (plan.splits - 1) * plan.rows < m <= plan.splits * plan.rows
    tiles_m = -(-k // planner.AT_B_TILE_K)
    tiles_n = -(-n // planner.AT_B_TILE_N)
    if plan.splits > 1:
        assert plan.rows >= planner.AT_B_MIN_ROWS and plan.wide_rows == k
        assert plan.ctas == tiles_m * tiles_n * plan.splits
    else:
        assert plan.wide_rows == k or \
            plan.wide_rows % planner.AT_B_TILE_K == 0
        wide = -(-plan.wide_rows // planner.AT_B_TILE_K)
        assert plan.ctas == wide * tiles_n + (tiles_m - wide) * -(
            -n // planner.AT_B_NARROW_N)


@pytest.mark.parametrize("stride,block_p", [
    (1, None), (1, 16), (1, 4), (2, None), (2, 5)],
    ids=["whole", "row-block", "col-block", "strided", "strided-rows"])
def test_col2im_patches_matches_reference(stride, block_p):
    """Both of the reference's ``block_p`` forms give the same dx as the
    port's one gather."""
    h = 10 if stride == 1 else 11
    oh = (h - 3) // stride + 1
    dp = _rand(oh, 2, oh * oh, 3 * 3 * 4)
    want = ref_col2im(jnp.asarray(dp), kh=3, kw=3, stride=stride, h=h, w=h,
                      block_p=block_p)
    got = k12.col2im_patches(torch.from_numpy(dp), kh=3, kw=3,
                             stride=stride, h=h, w=h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("stride", [1, 2, 3])
def test_col2im_is_the_adjoint_of_im2col(stride):
    """<im2col(x), dp> == <x, col2im(dp)>."""
    x = torch.from_numpy(_rand(1, 2, 9, 9, 3))
    oh = (9 - 3) // stride + 1
    dp = torch.from_numpy(_rand(2, 2, oh * oh, 27))
    lhs = torch.sum(k12.im2col_patches(x, kh=3, kw=3, stride=stride) * dp)
    rhs = torch.sum(x * k12.col2im_patches(dp, kh=3, kw=3, stride=stride,
                                           h=9, w=9))
    assert lhs.item() == pytest.approx(rhs.item(), rel=1e-5)


@pytest.mark.parametrize("mode", ["resident", "streamed"])
@pytest.mark.parametrize("b,i,c,j,d,bi,iters", [
    (2, 100, 8, 10, 16, 24, 3),      # ragged final i-block
    (2, 27, 4, 4, 8, 8, 1),          # odd capsule count, one iteration
], ids=["ragged", "iters1"])
def test_votes_routing_bwd_matches_reference(mode, b, i, c, j, d, bi, iters):
    """(du, dW) of the twin against ``jax.grad`` through the reference's
    backward kernel of the same mode and i-tile (interpret mode)."""
    u = _rand(i, b, i, c, scale=0.5)
    w = _rand(i + 1, i, j * d, c, scale=0.3)
    g = _rand(i + 2, b, j * d)

    def loss(u_, w_):
        return jnp.sum(rops.votes_routing(
            u_, w_, iters=iters, num_classes=j, mode=mode, block_i=bi,
            bwd_mode=mode, bwd_block_i=bi) * jnp.asarray(g))

    want = _grads_jax(loss, (u, w), (0, 1))
    got = k34.votes_routing_bwd(torch.from_numpy(u), torch.from_numpy(w),
                                torch.from_numpy(g), iters=iters,
                                num_classes=j, mode=mode, block_i=bi)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.numpy(), y, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode,iters", [("resident", 3), ("streamed", 3),
                                        ("streamed", 1)])
def test_votes_routing_bwd_matches_autograd_of_the_plain_routing(mode, iters):
    """The explicit formula equals autograd through the port's
    ``routing_by_agreement`` (stop-gradient convention)."""
    b, i, c, j, d = 2, 40, 4, 5, 6
    u = torch.from_numpy(_rand(3, b, i, c, scale=0.5)).requires_grad_()
    w = torch.from_numpy(_rand(4, i, j * d, c, scale=0.3)).requires_grad_()
    g = torch.from_numpy(_rand(5, b, j * d))
    uh = T.compute_votes(u, w.reshape(i, j, d, c).permute(0, 1, 2, 3))
    torch.sum(T.routing_by_agreement(uh, iters).reshape(b, -1) * g).backward()
    du, dw = k34.votes_routing_bwd(u.detach(), w.detach(), g, iters=iters,
                                   num_classes=j, mode=mode, block_i=16)
    torch.testing.assert_close(du, u.grad, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(dw, w.grad, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("epilogue,sd,stride", [
    ("none", 0, 1), ("relu", 0, 1), ("relu", 0, 2), ("squash", 4, 2)])
def test_conv2d_im2col_grads_match_reference(epilogue, sd, stride):
    x = _rand(1, 2, 11, 11, 3)
    w = _rand(2, 3, 3, 3, 8, scale=0.2)
    bias = _rand(3, 8, scale=0.1)
    oh = (11 - 3) // stride + 1
    dy = _rand(4, 2, oh, oh, 8)

    def loss(x_, w_, b_):
        return jnp.sum(ref_conv(x_, w_, b_, stride=stride, block_m=16,
                                block_k=8, block_n=8, epilogue=epilogue,
                                squash_dim=sd) * jnp.asarray(dy))

    want = _grads_jax(loss, (x, w, bias), (0, 1, 2))
    xt, wt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, w, bias))
    out = k12.conv2d_im2col(xt, wt, bt, stride=stride, epilogue=epilogue,
                            squash_dim=sd)
    torch.sum(out * torch.from_numpy(dy)).backward()
    for t, y in zip((xt, wt, bt), want):
        np.testing.assert_allclose(t.grad.numpy(), y, rtol=1e-5, atol=1e-6)


def test_conv_backward_skips_the_gradients_no_one_asked_for():
    x = torch.from_numpy(_rand(1, 1, 8, 8, 1))
    w = torch.from_numpy(_rand(2, 3, 3, 1, 4)).requires_grad_()
    b = torch.zeros(4, requires_grad=True)
    out = k12.conv2d_im2col(x, w, b, epilogue="relu")
    grads = torch.autograd.grad(out.sum(), [w, b])
    assert x.grad is None and all(g is not None for g in grads)


@pytest.mark.parametrize("mode", ["resident", "streamed"])
def test_primary_routing_grads_match_reference(mode):
    """The K11 composite against ``jax.grad`` of the reference's
    pipelined op: gradients of x, W_pc, b_pc and W_cc."""
    b, h, cin, kh, n_ch, c, j, d = 2, 10, 8, 3, 16, 4, 4, 8
    i_dim = 16 * (n_ch // c)
    args = (_rand(1, b, h, h, cin, uniform=True),
            _rand(2, kh, kh, cin, n_ch, scale=0.2),
            _rand(3, n_ch, scale=0.1), _rand(4, i_dim, j * d, c, scale=0.3))
    g = _rand(5, b, j * d)

    def loss(*a):
        return jnp.sum(primary_caps_routing(
            *a, stride=2, iters=3, num_classes=j, mode=mode, block_i=24,
            block_k=32, bwd_block_i=24, conv_block_m=16, conv_block_k=8,
            conv_block_n=8) * jnp.asarray(g))

    want = _grads_jax(loss, args, (0, 1, 2, 3))
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    out = k5.primary_routing(*ts, stride=2, iters=3, num_classes=j,
                             mode=mode, block_i=24, bwd_mode=mode,
                             bwd_block_i=24)
    torch.sum(out * torch.from_numpy(g)).backward()
    for t, y in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), y, rtol=1e-5, atol=1e-6)
