"""The sharded ``CapsuleEngine`` on two CUDA devices (marker ``gpu``; no
JAX import, so it runs on the GPU machine): ``n_shards=2`` puts a shard
on each card and serves the single-device engine's lengths bit for bit,
on the kernels.  It skips below 2 GPUs; on one card chip_smoke phase 18
checks that ``n_shards=2`` is refused instead."""

import numpy as np
import pytest
import torch

from repro_torch.core import capsnet
from repro_torch.serve.capsule import CapsRequest, CapsuleEngine
from repro_torch.verify import check_engine_stats

pytestmark = pytest.mark.gpu

CFG = capsnet.CapsNetConfig(image_hw=14, conv1_channels=16, conv1_kernel=5,
                            pc_kernel=3, num_primary_groups=4, primary_dim=4,
                            class_dim=8, use_decoder=False)


def _serve(engine, images):
    for i, img in enumerate(images):
        engine.submit(CapsRequest(rid=i, image=img))
    engine.run()
    return {r.rid: np.asarray(r.lengths) for r in engine.finished}


def test_two_shards_on_two_cards_equal_one():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 CUDA devices: n_shards=2 puts a shard on each")
    params = capsnet.init_params(torch.Generator().manual_seed(0), CFG,
                                 device="cuda")
    images = np.random.default_rng(1).uniform(
        size=(16, CFG.image_hw, CFG.image_hw, 1)).astype(np.float32)
    want = _serve(CapsuleEngine(params, CFG, slots=16, device="cuda"), images)
    eng = CapsuleEngine(params, CFG, slots=16, device="cuda", n_shards=2)
    got = _serve(eng, images)
    assert [d.index for d in eng.mesh] == [0, 1]
    assert eng.plan.batch == 8
    for k in want:
        assert np.array_equal(got[k], want[k])
    assert eng._forward_builds == 1 and not check_engine_stats(eng.stats())
