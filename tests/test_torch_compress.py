"""The port's int8 error-feedback compression (``repro_torch.parallel.
compress``) against the reference's ``repro/parallel/compress.py``.

  * ``ef_quantize``: ``q`` equal to the reference's, the scale and the
    residual within 1 fp32 ulp, with and without a carried residual;
  * ``compress_grads_tree`` over a port tree: error feedback converges
    (the reference's ``tests/test_training.py`` case), leaf for leaf the
    reference's tree function;
  * ``compressed_psum`` over 4 gloo ranks (``run_ranks``): every rank gets
    the same result, within atol 2e-4 of the ranks' mean (the
    reference's bound), equal bit for bit to a single-process sum of the
    ranks' rounded payloads; at world 1 it is the reference's
    ``compressed_psum`` under ``shard_map`` on one device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from repro.parallel import compress as R
from repro.parallel.compat import shard_map
from repro_torch import tree
from repro_torch.parallel import compress
from repro_torch.parallel.ranks import run_ranks

WORLD, SEED, N = 4, 5, 1031


def _ulps(a, b):
    return np.max(np.abs(np.asarray(a, np.float32) - np.asarray(
        b, np.float32)) / np.spacing(np.maximum(np.abs(np.asarray(
            b, np.float32)), np.float32(1e-30))))


@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("scale", [1e-2, 3.0, 1e-9])
def test_ef_quantize_matches_the_reference(scale, with_residual):
    rng = np.random.default_rng(0)
    g = (rng.standard_normal(513) * scale).astype(np.float32)
    r = ((rng.standard_normal(513) * scale * 1e-2).astype(np.float32)
         if with_residual else None)
    q, s, nr = compress.ef_quantize(
        torch.from_numpy(g), None if r is None else torch.from_numpy(r))
    rq, rs, rnr = R.ef_quantize(jnp.asarray(g),
                                None if r is None else jnp.asarray(r))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    assert _ulps(s.numpy(), rs) <= 1
    assert _ulps(nr.numpy(), rnr) <= 1
    deq = compress.ef_dequantize(q, s)
    np.testing.assert_allclose(deq.numpy(), g + (0 if r is None else r),
                               atol=float(s) + 1e-9)


def test_error_feedback_unbiased_over_time():
    """Accumulated compressed updates converge to the accumulated true
    gradients (the reference's case), and each step's tree equals the
    reference's tree function leaf for leaf."""
    g = {"a": torch.full((64,), 0.003), "b": [torch.linspace(-1, 1, 9)]}
    res = None
    rres = None
    total = tree.tree_map(torch.zeros_like, g)
    rg = {"a": jnp.full((64,), 0.003), "b": [jnp.linspace(-1, 1, 9)]}
    for _ in range(50):
        cg, res = compress.compress_grads_tree(g, res)
        rcg, rres = R.compress_grads_tree(rg, rres)
        for got, want in zip(tree.leaves(cg), jax.tree_util.tree_leaves(
                rcg)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-7)
        total = tree.tree_map(torch.add, total, cg)
    np.testing.assert_allclose(total["a"].numpy(), 50 * 0.003, rtol=0.02)


def test_compressed_psum_at_world_one_matches_the_reference():
    g = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (32,))) * 0.01
    mesh = jax.make_mesh((1,), ("d",))

    def f(x):
        out, _ = R.compressed_psum(x, "d", world=1)
        return out

    want = shard_map(f, mesh=mesh, in_specs=jax.sharding.PartitionSpec(None),
                     out_specs=jax.sharding.PartitionSpec(None))(
                         jnp.asarray(g))
    out = run_ranks(torch_ranks.compress_world_one, 1, args=(g,))[0]
    np.testing.assert_allclose(out, np.asarray(want), rtol=0, atol=1e-7)
    np.testing.assert_allclose(out, g, atol=2e-4)


@pytest.fixture(scope="module")
def four_ranks():
    return run_ranks(torch_ranks.compress_body, WORLD, args=(SEED, N),
                     timeout_s=120)


def test_compressed_psum_over_four_ranks_is_the_mean(four_ranks):
    outs = [r["out"] for r in four_ranks]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    mean = np.mean([r["g"] for r in four_ranks], axis=0)
    np.testing.assert_allclose(four_ranks[0]["out_nores"], mean, atol=2e-4)
    carried = np.mean([r["g"] + WORLD * r["r"] for r in four_ranks], axis=0)
    np.testing.assert_allclose(outs[0], carried, atol=2e-4)


@pytest.mark.parametrize("key,res", [("out", True), ("out_nores", False)])
def test_compressed_psum_is_the_sum_of_the_rounded_payloads(four_ranks, key,
                                                            res):
    """One process recomputes every rank's payload (pre-divided by the
    world, the scales max-reduced, rounded, summed as int32): the
    all-reduce's result bit for bit, and each rank's residual."""
    g32 = [torch.from_numpy(r["g"]) / WORLD
           + (torch.from_numpy(r["r"]) if res else 0) for r in four_ranks]
    scale = max(compress._scale_of(x) for x in g32)
    qs = [torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
          for x in g32]
    summed = torch.stack([q.to(torch.int32) for q in qs]).sum(0)
    np.testing.assert_array_equal(four_ranks[0][key],
                                  (summed.float() * scale).numpy())
    if res:
        for r, x, q in zip(four_ranks, g32, qs):
            np.testing.assert_array_equal(r["res"],
                                          (x - q.float() * scale).numpy())
