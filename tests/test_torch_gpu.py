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

from repro_torch.configs import capsnet_mnist
from repro_torch.core import capsnet, execplan
from repro_torch.kernels import build
from repro_torch.kernels import conv_im2col as k12
from repro_torch.kernels import primary_routing as k5
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
            k12.matmul_bias_act(p2, w2, b_pc, block_m=32, block_k=16,
                                block_n=32, epilogue=epi, squash_dim=sd),
            k12.matmul_bias_act_plain(p2, w2, b_pc, epilogue=epi,
                                      squash_dim=sd), rtol=1e-5, atol=1e-5)
    u = _rand(5, 2, 64, 4, scale=0.5, device=cuda)
    for mode in ("resident", "streamed"):
        kw = dict(iters=3, num_classes=4, mode=mode, block_i=24)
        torch.testing.assert_close(k34.votes_routing(u, w_cc, **kw),
                                   k34.votes_routing_plain(u, w_cc, **kw),
                                   rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(
            k5.primary_routing_patches(p, w2, b_pc, w_cc, block_k=32, **kw),
            k5.primary_routing_patches_plain(p, w2, b_pc, w_cc, **kw),
            rtol=1e-5, atol=1e-6)
    assert all(n > 0 for n in build.launch_counts().values())


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
    routed = "primary_routing_f32" if pipeline else "votes_routing_f32"
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
