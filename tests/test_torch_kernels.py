"""The port's kernel modules against the reference's Pallas kernels.

Inputs are made with numpy from a seed and go through both: the
reference's wrappers in interpret mode (as tests/test_conv_kernels.py and
tests/test_votes_routing.py run them) and the port's wrappers on CPU
tensors, which run the plain PyTorch twins.  Tolerances are the
reference's own: 1e-5 for the conv kernels, rtol 1e-5 / atol 1e-6 for
routing.  The CUDA kernels themselves are held against the same twins on
the card by tests/test_torch_gpu.py (and by ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.kernels.conv_im2col import im2col_patches as ref_patches
from repro.kernels.conv_im2col import matmul_bias_act as ref_matmul
from repro.kernels.primary_routing import primary_caps_routing
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
@pytest.mark.parametrize("m,k,n", [(37, 75, 24), (16, 8, 8)])
def test_matmul_bias_act_matches_reference(epilogue, sd, m, k, n):
    """Ragged M/N tiles and a K that is not a multiple of block_k."""
    p = _rand(m, m, k, uniform=True)
    w = _rand(k, k, n, scale=0.3)
    bias = _rand(n, n, scale=0.1)
    want = ref_matmul(jnp.asarray(p), jnp.asarray(w), jnp.asarray(bias),
                      block_m=8, block_k=16, block_n=8, epilogue=epilogue,
                      squash_dim=sd)
    got = k12.matmul_bias_act(torch.from_numpy(p), torch.from_numpy(w),
                              torch.from_numpy(bias), block_m=32, block_k=16,
                              block_n=8, epilogue=epilogue, squash_dim=sd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


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
        block_i=24, block_k=32)
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
    assert set(build.REGISTRY) == {"im2col_patches_f32",
                                   "matmul_bias_act_f32",
                                   "votes_routing_f32", "primary_routing_f32"}
    assert all(isinstance(n, int) for n in build.launch_counts().values())
