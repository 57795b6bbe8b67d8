"""The port's sharded LM state on the CPU: four gloo ranks
(``parallel.ranks.run_ranks``) running granite's smoke config, after
``tests/test_training.py``'s elastic restore.

The ranks run once for the module (``tests/torch_ranks.restore_body``):

  * a step with ``grad_shardings`` and a ZeRO-1 step (the moments by
    ``zero1_shardings``, sharded over ``data`` too) match the unsharded
    port step within rtol 2e-4, as the plain sharded step does;
  * a checkpoint written at (2, 2) (rank 0 writes full tensors) restores
    onto (1, 4), and onto one process, with the same values;
  * a sharded ``TrainLoop`` (bf16 compute) run 3 steps at (2, 2) and
    resumed to 5 at (1, 4) gives the unsharded loop's losses and gradient
    norms within the repo's bf16 step bounds (1e-2, 5e-2), its first loss
    within 2e-4;
  * the sharded prefill and decode steps give the unsharded logits (to
    1e-5) and the same greedy tokens.
"""

import numpy as np
import pytest
import torch

import torch_ranks
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import steps
from repro_torch.parallel.ranks import run_ranks
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer
from repro_torch.train.loop import LoopConfig, TrainLoop
from torch_lm_cases import RTOL_SHARDED, case, port_step

ARCH = "granite-3-2b"


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    ckpt_dir = tmp_path_factory.mktemp("ckpt")
    loop_dir = tmp_path_factory.mktemp("loop")
    out = run_ranks(torch_ranks.restore_body, 4,
                    args=(*case(ARCH), str(ckpt_dir), str(loop_dir)),
                    timeout_s=180)
    return out, ckpt_dir


def test_zero1_and_grad_shardings_steps(ranks):
    out, _ = ranks
    r = out[0]
    want = port_step(ARCH)
    for name in ("step", "zero1_step", "grad_shardings_step"):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(r[name][k], want[k],
                                       rtol=RTOL_SHARDED)
    assert all(x["zero1_kept"] for x in out)
    assert r["zero1_sharded"] > 0


def test_checkpoint_restores_onto_another_mesh_and_one_process(ranks):
    out, ckpt_dir = ranks
    written = out[0]["written"]
    assert written and out[0]["restored_step"] == 1
    for r in out:
        assert r["restored_mesh"]
        assert set(r["restored"]) == set(written)
        for k, v in written.items():
            np.testing.assert_array_equal(r["restored"][k], v)
    # Onto one process: a plain template, no mesh.
    template = {"params": lm_params_from_numpy(case(ARCH)[0], "cpu")}
    restored, manifest = ckpt.restore(template, ckpt_dir)
    assert manifest["step"] == 1
    for k, v in tree.leaves_with_keys(restored["params"]):
        np.testing.assert_array_equal(v.numpy(), written[k])


def test_sharded_train_loop_resumes_on_another_mesh(ranks, tmp_path):
    out, _ = ranks
    cfg = registry.get_smoke_config(ARCH)
    loop = TrainLoop(cfg, optimizer.OptConfig(**torch_ranks.LOOP_OPT),
                     torch_ranks.loop_data(cfg),
                     LoopConfig(total_steps=5, ckpt_every=2,
                                ckpt_dir=str(tmp_path), log_every=1000),
                     device="cpu")
    want = [(r["step"], r["loss"], r["grad_norm"]) for r in loop.run()]
    for r in out:
        assert r["loop"] == out[0]["loop"]
    got = out[0]["loop"]
    assert [s for s, _, _ in got] == [1, 2, 3, 4, 5]
    # The loop computes in bf16: the repo's bf16 step bounds (loss 1e-2,
    # gradient norm 5e-2, ``tests/test_torch_lm_train.py``) hold; the
    # first step, before any update, agrees far closer.
    np.testing.assert_allclose([x[1] for x in got], [x[1] for x in want],
                               rtol=1e-2)
    np.testing.assert_allclose([x[2] for x in got], [x[2] for x in want],
                               rtol=5e-2)
    np.testing.assert_allclose(got[0][1], want[0][1], rtol=RTOL_SHARDED)


def test_sharded_prefill_and_serve_steps(ranks):
    out, _ = ranks
    np_params, batch = case(ARCH)
    cfg = registry.get_smoke_config(ARCH)
    params = lm_params_from_numpy(np_params, "cpu")
    toks = torch.from_numpy(batch["inputs"][:, :8])
    logits, cache = steps.make_prefill_step(cfg, 12)(params, toks)
    nxt, dec, _ = steps.make_serve_step(cfg)(
        params, cache, torch.full((toks.shape[0], 1), 3), 8)
    for r in out:
        np.testing.assert_allclose(r["prefill"], logits.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(r["decode"], dec.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(r["next"], nxt.numpy())
