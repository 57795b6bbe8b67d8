"""The port's sharded CapsuleEngine (``n_shards``) on the CPU, case for
case after ``tests/test_sharded_serving.py``.

On ``device="cpu"`` every shard of ``parallel.sharding.slot_mesh`` is the
CPU: each holds a replica of the parameters and its block of the slot
batch, runs its own forward on its per-shard plan and gathers its rows by
a shard-local index.  The claims held here, at 1, 2, 4 and 8 shards on
both backends (``kernels`` runs the plain twins on the CPU):

  * the lengths and predictions equal the single-device port engine's bit
    for bit, and the reference engine's to 1e-5 (the engine tolerance of
    ``tests/test_torch_engine_faults.py``);
  * ONE forward build (``_forward_builds``) however many shards;
  * 8 shards x 2 slots fill all 16 slots in the first tick;
  * one ``compile_plan`` gives the per-shard plan (``plan.batch == 2`` at 8
    shards);
  * a ``vmem_shrink`` under 2 shards replans once and builds twice; a NaN
    storm under 4 shards ends every request terminal; the per-shard
    counters plus the queue bucket pass ``check_engine_stats``;
  * ``slots % n_shards`` and a plan below ``slots_per_shard`` are refused.

The multi-GPU counterpart (``n_shards=2`` on two cards) is in
``tests/test_torch_sharded_gpu.py``.
"""

import jax
import numpy as np
import pytest

from repro.core import capsnet as R
from repro.serve import CapsRequest as RefRequest
from repro.serve import CapsuleEngine as RefEngine
from repro_torch.convert import params_from_numpy
from repro_torch.core import capsnet, faults
from repro_torch.core.execplan import PlanError, compile_plan
from repro_torch.parallel import sharding
from repro_torch.serve.capsule import CapsRequest, CapsuleEngine
from repro_torch.verify import check_engine_stats

FIELDS = dict(image_hw=14, conv1_channels=16, conv1_kernel=5, pc_kernel=3,
              num_primary_groups=4, primary_dim=4, class_dim=8,
              use_decoder=False)
REF_CFG = R.CapsNetConfig(**FIELDS)
CFG = capsnet.CapsNetConfig(**FIELDS)
REF_PARAMS = R.init_params(jax.random.PRNGKey(0), REF_CFG)
PARAMS = params_from_numpy({k: np.asarray(v) for k, v in REF_PARAMS.items()},
                           "cpu")
IMGS = np.random.default_rng(1).uniform(
    size=(16, CFG.image_hw, CFG.image_hw, 1)).astype(np.float32)
TICK, FWD = faults.SITE_ENGINE_TICK, faults.SITE_ENGINE_FORWARD


def _serve(engine, n=16, req=CapsRequest):
    for i in range(n):
        engine.submit(req(rid=i, image=IMGS[i % len(IMGS)]))
    engine.run()
    return {r.rid: (np.asarray(r.lengths), r.pred) for r in engine.finished}


def _engine(**kw):
    return CapsuleEngine(PARAMS, CFG, device="cpu", **kw)


@pytest.fixture(scope="module")
def single():
    """The single-device port engine's results, by backend."""
    return {b: _serve(_engine(slots=16, backend=b))
            for b in ("torch", "kernels")}


@pytest.fixture(scope="module")
def reference():
    return _serve(RefEngine(REF_PARAMS, REF_CFG, slots=16), req=RefRequest)


@pytest.mark.parametrize("backend", ["torch", "kernels"])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_sharded_parity_bit_identical(single, reference, backend, n):
    eng = _engine(slots=16, backend=backend, n_shards=n)
    got = _serve(eng)
    want = single[backend]
    assert set(got) == set(want) == set(range(16))
    for k in want:
        assert np.array_equal(got[k][0], want[k][0]) and got[k][1] == want[k][1]
        np.testing.assert_allclose(got[k][0], reference[k][0], rtol=1e-5,
                                   atol=1e-5)
    assert eng._forward_builds == 1
    s = eng.stats()
    assert s["n_shards"] == n and s["slots_per_shard"] == 16 // n
    assert len(s["per_shard"]) == n and not check_engine_stats(s)
    if backend == "kernels":
        assert eng.plan.batch == 16 // n and eng.plan.pipelined


def test_full_mesh_serves_concurrently_one_build():
    eng = _engine(slots=16, n_shards=8)
    for i in range(16):
        eng.submit(CapsRequest(rid=i, image=IMGS[i]))
    eng.step()
    s = eng.stats()
    assert s["ok"] == 8 * eng.slots_per_shard == 16
    assert s["occupancy"] == 1.0 and eng._forward_builds == 1
    assert [sh["ok"] for sh in s["per_shard"]] == [2] * 8


def test_admission_interleaves_the_shards():
    eng = _engine(slots=8, n_shards=4)
    for i in range(4):
        eng.submit(CapsRequest(rid=i, image=IMGS[i]))
    eng._admit()
    assert [s for s, r in enumerate(eng.active) if r is not None] == \
        [0, 2, 4, 6]


def test_kernels_per_shard_plan():
    eng = _engine(slots=16, backend="kernels", n_shards=8)
    assert eng.plan.batch == 2
    assert eng.plan == compile_plan(CFG, batch=2, pipeline=True)


def test_vmem_shrink_under_sharding_one_rebuild():
    with faults.inject(faults.FaultSpec(site=TICK, kind="vmem_shrink",
                                        at=1, times=2, factor=0.125)):
        eng = _engine(slots=8, backend="kernels", n_shards=2)
        got = _serve(eng)
    s = eng.stats()
    assert s["ok"] == 16 and s["replans"] == 1 and s["degraded"]
    assert eng.plan.batch == 4 and not eng.plan.pipelined
    assert eng._forward_builds == 2          # healthy build + degraded one
    assert not check_engine_stats(s)
    ref = _serve(_engine(slots=16, backend="kernels"))
    for k in ref:
        np.testing.assert_allclose(got[k][0], ref[k][0], rtol=1e-4,
                                   atol=1e-4)


def test_nan_storm_under_sharding_terminal():
    with faults.inject(faults.FaultSpec(site=FWD, kind="nan_output", at=0,
                                        times=2)):
        eng = _engine(slots=8, n_shards=4, retry_backoff_ticks=0)
        _serve(eng)
    s = eng.stats()
    assert s["ok"] + s["timeout"] + s["error"] + s["shed"] == \
        s["submitted"] == 16
    assert s["poisoned"] >= 2 and not check_engine_stats(s)


def test_slot_corrupt_lands_on_its_shard_and_heals():
    with faults.inject(faults.FaultSpec(site=TICK, kind="slot_corrupt",
                                        at=0, times=1, seed=7)):
        eng = _engine(slots=8, n_shards=4)
        _serve(eng, n=8)
    s = eng.stats()
    assert s["ok"] == 8 and s["poisoned"] == 1 and s["retries"] == 1
    assert not check_engine_stats(s)


def test_refusals():
    with pytest.raises(ValueError, match="does not divide"):
        _engine(slots=6, n_shards=4)
    with pytest.raises(ValueError, match="n_shards=0"):
        sharding.slot_mesh(0, "cpu")
    with pytest.raises(PlanError, match="per shard"):
        _engine(slots=16, n_shards=2, backend="kernels",
                plan=compile_plan(CFG, batch=4, pipeline=True))
    # A plan for exactly slots_per_shard rows serves.
    _engine(slots=16, n_shards=4, backend="kernels",
            plan=compile_plan(CFG, batch=4, pipeline=True))


def test_slot_mesh_on_cuda_needs_the_devices():
    import torch
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match=f"{n} visible"):
        sharding.slot_mesh(n + 1, "cuda")
    assert sharding.slot_batch_spec() == ("shards",)
    assert sharding.slot_param_spec() == ()


def test_serving_example_with_shards(capsys):
    """``examples/serve_capsnet_torch.py --shards 2``: one per-shard plan,
    every request served."""
    import pathlib
    import runpy
    path = pathlib.Path(__file__).parents[1] / "examples" / \
        "serve_capsnet_torch.py"
    main = runpy.run_path(str(path), run_name="example")["main"]
    main(["--device", "cpu", "--shards", "2", "--slots", "4",
          "--requests", "6"])
    out = capsys.readouterr().out
    assert "served 6 requests (kernels backend on cpu, 4 slots, 2 shards " \
        "x 2 slots/shard)" in out

