"""The port's sharded LM step over ``torch.distributed`` on the CPU: four
gloo ranks (``parallel.ranks.run_ranks``) on a (2, 2) ("data", "model")
mesh, after ``tests/test_sharding.py`` and ``tests/test_variants.py``.

The ranks run once for the module (``tests/torch_ranks.step_body``):

  * granite, zamba2 and deepseek smoke configs: the sharded fp32 train
    step's loss and gradient norm are within rtol 2e-4 of the unsharded
    port step (the reference's bound for its 2x4 mesh), which is within
    rtol 1e-5 of the reference's step (the port's fp32 step tolerance);
  * ``manual_tp=True`` (``rs_proj`` / ``ag_seq``) matches the
    auto-sharded loss and step within rtol 2e-4;
  * each rank's local parameter shards have the shapes ``param_pspecs``
    implies;
  * after the step every rank holds the same full parameters and Adam
    moments, bit for bit (the gradient reduction leaves no replica
    apart);
  * the sharded prefill and decode steps (an fp32 cache: a bf16 one
    rounds the sharded and unsharded keys apart wherever their fp32
    values differ in the last bits) give the unsharded logits (to 1e-5)
    and the same greedy tokens: attention with a cache on local shards,
    MLA's absorbed form, the SSD scan and step on local shards.

The checkpoints, the loop and ZeRO-1 are in
``tests/test_torch_sharded_restore.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from repro.configs import get_smoke_config as ref_smoke
from repro.launch import steps as ref_steps
from repro.train import optimizer as ref_opt
from repro_torch.configs import registry
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import steps
from repro_torch.parallel.ranks import run_ranks
from torch_lm_cases import RTOL_SHARDED, case, port_step

ARCHS = ["granite-3-2b", "zamba2-1.2b", "deepseek-v2-lite-16b"]
RTOL_REF = 1e-5           # the port's fp32 step against the reference's


@pytest.fixture(scope="module")
def ranks():
    cases = [(arch, *case(arch)) for arch in ARCHS]
    return run_ranks(torch_ranks.step_body, 4, args=(cases,),
                     timeout_s=180)


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_the_unsharded_step(ranks, arch):
    want = port_step(arch)
    for r in ranks:
        assert r["metrics"][arch] == ranks[0]["metrics"][arch]
    got = ranks[0]["metrics"][arch]
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL_SHARDED)
    assert got["lr"] == want["lr"]


@pytest.mark.parametrize("arch", ARCHS)
def test_unsharded_port_step_matches_the_reference(arch):
    np_params, batch = case(arch)
    rp = jax.tree_util.tree_map(jnp.asarray, np_params)
    r_step = ref_steps.make_train_step(
        ref_smoke(arch), ref_opt.OptConfig(**torch_ranks.OPT),
        compute_dtype=jnp.float32)
    _, _, rm = jax.jit(r_step)(rp, ref_opt.init_opt_state(rp),
                               {k: jnp.asarray(v, jnp.int32)
                                for k, v in batch.items()})
    got = port_step(arch)
    for k in ("loss", "ce", "grad_norm"):
        np.testing.assert_allclose(got[k], float(rm[k]), rtol=RTOL_REF)


@pytest.mark.parametrize("arch", ARCHS)
def test_every_rank_holds_the_same_parameters_and_moments(ranks, arch):
    want = ranks[0]["digests"][arch]
    assert len(want) > 0
    for r in ranks[1:]:
        differ = sorted(k for k, v in r["digests"][arch].items()
                        if v != want[k])
        assert not differ, f"{arch}: replicas differ in {differ}"


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_match_the_unsharded_steps(ranks, arch):
    np_params, batch = case(arch)
    cfg = registry.get_smoke_config(arch)
    params = lm_params_from_numpy(np_params, "cpu")
    toks = torch.from_numpy(batch["inputs"][:, :8])
    logits, cache = steps.make_prefill_step(
        cfg, 12, cache_dtype=torch.float32)(params, toks)
    nxt, dec, _ = steps.make_serve_step(cfg)(
        params, cache, torch.full((toks.shape[0], 1), 3), 8)
    for r in ranks:
        got = r["serve"][arch]
        np.testing.assert_allclose(got["prefill"], logits.numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["decode"], dec.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(got["next"], nxt.numpy())


def test_manual_tp_matches_the_auto_sharded_step(ranks):
    r = ranks[0]
    np.testing.assert_allclose(r["manual_tp"]["manual"],
                               r["manual_tp"]["auto"], rtol=RTOL_SHARDED)
    auto = r["metrics"]["granite-3-2b"]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(r["manual_step"][k], auto[k],
                                   rtol=RTOL_SHARDED)
    assert r["manual_collectives"] > 0


def test_local_shards_have_the_shapes_of_their_specs(ranks):
    assert all(r["local_ok"] for r in ranks)
    assert ranks[0]["n_sharded_leaves"] > 0
