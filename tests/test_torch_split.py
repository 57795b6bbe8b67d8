"""The split ClassCaps path (K14a ``caps_votes`` -> K14b ``routing``), the
standalone squash (K10) and the ``ops.*`` fault sites, on the CPU.

Inputs are made with numpy from a seed and go through the reference's
wrappers in interpret mode and the port's wrappers on CPU tensors, which
run the plain twins (the CUDA kernels are held against the same twins
on the card by tests/test_torch_gpu.py and ``chip_smoke.py``).
Tolerances are the reference's own: rtol 1e-5 / atol 1e-5 for the votes
(tests/test_kernels.py), rtol 1e-5 / atol 1e-6 for routing, the squash
and its gradient, and for the forward of a network whose capsule no GEMM
tile can hold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import capsnet as R
from repro.core import execplan as ref_execplan
from repro.kernels import ops as rops
from repro.kernels.squash import squash as ref_squash
from repro_torch.convert import params_from_numpy
from repro_torch.core import capsnet as T
from repro_torch.core import execplan, faults, planner
from repro_torch.core.execplan import PlanError
from repro_torch.kernels import caps_votes as k14a
from repro_torch.kernels.conv_im2col import conv2d_im2col
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.kernels import routing as k14b
from repro_torch.kernels import squash as k10
from repro_torch.kernels import votes_routing as k34


def _rand(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# K14a caps_votes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bi", [32, 64, 128, 256])
def test_caps_votes_block_sweep_matches_reference(bi):
    u, w = _rand(0, 2, 256, 8), _rand(1, 256, 160, 8)
    want = rops.caps_votes(jnp.asarray(u), jnp.asarray(w), block_i=bi)
    got = ops.caps_votes(torch.from_numpy(u), torch.from_numpy(w),
                         block_i=bi)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("i,bi", [(300, 128), (135, 32), (27, 8), (100, 256)])
def test_caps_votes_ragged_tail_matches_reference(i, bi):
    """I need not divide block_i: the last block is ragged."""
    u, w = _rand(i, 2, i, 8), _rand(i + 1, i, 40, 8)
    want = rops.caps_votes(jnp.asarray(u), jnp.asarray(w), block_i=bi)
    got = ops.caps_votes(torch.from_numpy(u), torch.from_numpy(w),
                         block_i=bi)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_caps_votes_planned_block_matches_reference():
    """The default (the Hopper planner's pick) at a non-power-of-two I."""
    u, w = _rand(2, 1, 1100, 8), _rand(3, 1100, 160, 8)
    want = rops.caps_votes(jnp.asarray(u), jnp.asarray(w))
    got = ops.caps_votes(torch.from_numpy(u), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_fmaf_twin_rounds_once():
    """The twin's ``fmaf`` against the exact sum rounded once: random
    operands at three scales, and a sum that fp64 rounds onto an fp32
    midpoint (a plain fp64 sum then rounds the wrong way)."""
    from fractions import Fraction
    rng = np.random.default_rng(5)
    a, b = (rng.standard_normal(300).astype(np.float32) for _ in range(2))
    c = np.concatenate([rng.standard_normal(100) * s
                        for s in (1.0, 1e-12, 1e12)]).astype(np.float32)
    a = np.append(a, np.float32(2**-12 * (1 + 2**-23)))
    b = np.append(b, np.float32(2**-12 * (1 - 2**-23)))
    c = np.append(c, np.float32(1 + 2**-23))
    got = k14a.fmaf(*(torch.from_numpy(t) for t in (a, b, c))).numpy()
    for k in range(len(a)):
        exact = Fraction(float(a[k])) * Fraction(float(b[k])) \
            + Fraction(float(c[k]))
        lo = np.float32(float(exact))             # within an fp32 ulp
        hi = np.nextafter(lo, np.float32(np.inf if exact > Fraction(
            float(lo)) else -np.inf))
        d_lo = abs(Fraction(float(lo)) - exact)
        d_hi = abs(Fraction(float(hi)) - exact)
        want = lo if d_lo < d_hi or (d_lo == d_hi and not
                                     np.float32(lo).view(np.int32) & 1) \
            else hi
        assert got[k] == want, k
    assert got[-1] == np.float32(1 + 2**-23)
    assert np.float32(np.float64(c[-1]) + np.float64(a[-1])
                      * np.float64(b[-1])) != got[-1]


# ---------------------------------------------------------------------------
# K14b routing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("iters", [1, 2, 3, 5])
@pytest.mark.parametrize("b,i,j,d", [(1, 64, 10, 16), (3, 96, 4, 8)])
def test_routing_matches_reference(iters, b, i, j, d):
    uh = _rand(i + iters, b, i, j * d, scale=0.1)
    want = rops.routing(jnp.asarray(uh), iters=iters, num_classes=j)
    got = ops.routing(torch.from_numpy(uh), iters=iters, num_classes=j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("block_i", [1, 24, 96])
def test_routing_tiles_do_not_change_the_result(block_i):
    """The kernel's u_hat tiles, ragged (96 rows in tiles of 24 -> 4, of
    1 -> 96) or whole, against the reference."""
    uh = _rand(9, 2, 96, 32, scale=0.1)
    want = rops.routing(jnp.asarray(uh), iters=3, num_classes=4)
    got = k14b.routing(torch.from_numpy(uh), iters=3, num_classes=4,
                       block_i=block_i)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_split_path_equals_fused_votes_routing_at_mnist_width():
    """caps_votes -> routing at I=1152, J=10, D=16, batch 2, against the
    port's fused votes_routing, the reference's split path and the
    reference's fused kernel."""
    u = _rand(10, 2, 1152, 8, scale=0.3)
    w = _rand(11, 1152, 160, 8, scale=0.1)
    ut, wt = torch.from_numpy(u), torch.from_numpy(w)
    split = ops.routing(ops.caps_votes(ut, wt))
    fused = ops.votes_routing(ut, wt)
    np.testing.assert_allclose(split.numpy(), fused.detach().numpy(),
                               rtol=1e-5, atol=1e-6)
    uj, wj = jnp.asarray(u), jnp.asarray(w)
    for want in (rops.routing(rops.caps_votes(uj, wj)),
                 rops.votes_routing(uj, wj)):
        np.testing.assert_allclose(split.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# K10 squash and its VJP
# ---------------------------------------------------------------------------

SQUASH_CASES = [((2, 1152, 8), 1024),      # the PrimaryCaps capsules
                ((300, 256), 128),         # a row per warp, ragged rows
                ((7, 5), 3),               # odd D, ragged rows
                ((3, 40, 160), None)]      # the Hopper pick for D


@pytest.mark.parametrize("shape,block_rows", SQUASH_CASES)
def test_squash_matches_reference(shape, block_rows):
    x = _rand(len(shape), *shape)
    want = ref_squash(jnp.asarray(x), block_rows=block_rows or 1024)
    got = ops.squash(torch.from_numpy(x), block_rows=block_rows)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("shape,block_rows", SQUASH_CASES)
def test_squash_grad_matches_reference_vjp(shape, block_rows):
    """d/dx sum(squash(x) * g) through the port's Function against
    ``jax.grad`` through the reference's custom VJP."""
    x, g = _rand(1, *shape), _rand(2, *shape)

    def loss(xj):
        return jnp.sum(ref_squash(xj, block_rows=block_rows or 1024)
                       * jnp.asarray(g))

    want = jax.grad(loss)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    (ops.squash(xt, block_rows=block_rows) * torch.from_numpy(g)).sum() \
        .backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_squash_backward_is_the_twin_of_the_vjp_formula():
    x, g = torch.from_numpy(_rand(3, 33, 8)), torch.from_numpy(_rand(4, 33, 8))
    torch.testing.assert_close(k10.squash_bwd(x, g, block_rows=4),
                               ref.squash_vjp(x, g), rtol=0, atol=0)
    with pytest.raises(ValueError, match="cotangent"):
        k10.squash_bwd(x, g[:3], block_rows=4)


# ---------------------------------------------------------------------------
# The Hopper plan of the split path and of the unfused squash
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch", [1, 8, 64, 512, 4096])
@pytest.mark.parametrize("i,n", [(1152, 160), (300, 40), (7, 160)])
def test_plan_caps_votes_fits_and_spreads_over_the_sms(batch, i, n):
    """The pick gives every thread one (i, n) column of a CTA of at most
    256 threads, a grid over every SM (every row where I is smaller) and
    a footprint (u for a chunk of samples) within the budget."""
    bi = execplan.plan_caps_votes(i, 8, n, batch)
    ctas, threads = execplan.caps_votes_grid(i, n, bi)
    assert 1 <= bi <= i and ctas == -(-i // bi)
    assert ctas >= min(planner.NUM_SMS, i)
    assert bi == 1 or bi * n <= threads <= execplan.CTA_THREADS
    assert threads % 32 == 0 and threads >= min(bi * n, 32)
    assert execplan.caps_votes_smem(batch, bi, 8) == 4 * min(
        batch, execplan.CAPS_VOTES_CHUNK) * bi * 8 <= planner.SMEM_BYTES
    assert ops.planned_block_i(i, 8, n, batch) == bi


def test_plan_caps_votes_raises_naming_classcaps_fc():
    """u is staged a chunk of samples at a time, so no batch is too large;
    a budget or a capsule width that one row's chunk does not fit, and a
    grid past CUDA's limit, raise naming the op."""
    assert execplan.plan_caps_votes(1152, 8, 160, 10_000) == 1
    assert execplan.plan_caps_votes(1152, 8, 160, 8, smem_budget=4_000) == 1
    with pytest.raises(PlanError, match="ClassCaps-FC"):
        execplan.plan_caps_votes(1152, 8, 160, 8, smem_budget=200)
    with pytest.raises(PlanError, match="ClassCaps-FC"):
        execplan.plan_caps_votes(1152, 1024, 160, 64)
    bi = execplan.plan_caps_votes(2**34, 8, 16, 8)   # 16 rows a CTA
    assert -(-2**34 // bi) <= execplan.CUDA_MAX_GRID
    with pytest.raises(PlanError, match="ClassCaps-FC"):
        execplan.plan_caps_votes(2**34, 8, 160, 8)    # one row a CTA
    with pytest.raises(PlanError, match="ClassCaps-FC"):
        ops.planned_block_i(2**35, 8, 40, 8)


@pytest.mark.parametrize("rows,d,want_lanes", [
    (9216, 8, 2), (128, 8, 2), (7, 8, 2), (7, 5, 2), (64, 4, 1),
    (4096, 256, 32), (9216, 160, 32), (32, 160, 32), (500, 1100, 32)])
def test_squash_plan_spreads_rows_over_the_sms(rows, d, want_lanes):
    """K10's lanes hold the row in registers (up to 1024 floats), its CTA
    takes whole warps of rows in at most 256 threads, and its grid gives
    every SM a CTA unless the rows fill fewer warps than the card has
    SMs; no shared memory."""
    lanes = execplan.squash_lanes(d)
    assert lanes == want_lanes
    br = execplan.squash_block_rows(d, rows)
    ctas, threads = execplan.squash_grid(rows, br, lanes)
    per_warp = 32 // lanes
    assert 1 <= br <= rows and ctas == -(-rows // br)
    assert ctas >= min(planner.NUM_SMS, -(-rows // per_warp))
    assert threads % 32 == 0 and threads <= execplan.CTA_THREADS
    assert br * lanes <= threads or threads == execplan.CTA_THREADS
    with pytest.raises(ValueError, match="lanes"):
        k10.squash_rows(torch.zeros(rows, d), block_rows=br, lanes=3)


def test_plan_routing_split_fits_the_budget():
    """K14b's cluster schedule at MNIST width: each CTA's rows of u_hat on
    chip, its footprint the kernel's layout and within the budget; a
    budget that not even 16 CTAs streaming one row each fit raises."""
    sched = execplan.plan_routing_split(1152, 10, 160, batch=8)
    cs = sched.cluster.cluster
    assert sched.mode == "resident" and cs in execplan.CLUSTER_SIZES
    rows = -(-1152 // cs)
    assert sched.smem_bytes == execplan.routing_split_cluster_smem(
        "resident", 1152, sched.block_i, 10, 160, cs) == 4 * (
            rows * (161 + 10) + rows * 10 + 4 * 160) <= planner.SMEM_BYTES
    assert ops.planned_routing(1152, 10, 160, 3, 8) == ("resident",
                                                        sched.block_i, cs)
    with pytest.raises(PlanError, match="routing"):
        execplan.plan_routing_split(1152, 10, 160, smem_budget=3_000)


def test_split_global_bytes_match_the_reference():
    got = execplan.split_votes_routing_global_bytes(8, 1152, 8, 160)
    assert got == ref_execplan.split_votes_routing_hbm_bytes(8, 1152, 8, 160)
    assert got == (17_994_752.0, 11_796_480.0)


def test_split_plan_caches_are_bounded():
    for fn in (ops.planned_block_i, ops.planned_routing):
        assert fn.cache_info().maxsize == 64


WIDE = dict(image_hw=14, conv1_channels=24, conv1_kernel=5, pc_kernel=3,
            num_primary_groups=1, primary_dim=160, class_dim=8,
            decoder_hidden=(32, 64))


def test_unfusable_capsule_plans_the_standalone_squash():
    """No GEMM tile width holds a 160-float capsule: PrimaryCaps is the
    plain conv and carries K10's rows per CTA."""
    plan = execplan.compile_plan(T.CapsNetConfig(**WIDE), batch=2)
    pc = plan.op("PrimaryCaps")
    assert (pc.kernel, pc.fuses_squash) == ("conv_im2col", False)
    # 2 * 16 capsules, a warp a row: one row a CTA spreads them widest.
    assert pc.block_rows == execplan.squash_block_rows(160, 32) == 1
    fused = execplan.compile_plan(T.CapsNetConfig(), batch=8).op(
        "PrimaryCaps")
    # 8 * 1152 capsules of 8 floats, two lanes a row: 64 rows a CTA give
    # 144 CTAs, the most rows whose grid covers the 132 SMs.
    assert fused.fuses_squash and fused.block_rows == 64
    assert pc.global_bytes > 0


@pytest.fixture(scope="module")
def wide():
    cfg_r = R.CapsNetConfig(**WIDE)
    params_r = R.init_params(jax.random.PRNGKey(0), cfg_r)
    images = np.random.default_rng(0).random((2, 14, 14, 1), np.float32)
    want = {k: np.asarray(v) for k, v in R.forward(
        params_r, jnp.asarray(images), cfg_r, backend="jnp").items()}
    params = params_from_numpy({k: np.asarray(v)
                                for k, v in params_r.items()}, "cpu")
    return T.CapsNetConfig(**WIDE), params, images, want


def test_unfusable_capsule_forward_matches_reference(wide):
    cfg, params, images, want = wide
    plan = execplan.compile_plan(cfg, batch=2, pipeline=False)
    out = T.forward(params, images, cfg, backend="kernels", plan=plan,
                    device="cpu")
    for k in ("class_caps", "lengths", "reconstruction"):
        np.testing.assert_allclose(out[k].numpy(), want[k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_unfusable_capsule_gradients_match_the_plain_backend(wide):
    """The standalone squash's Function carries the gradient: every
    parameter's gradient on the kernels backend equals the plain one."""
    cfg, params, images, _ = wide
    plan = execplan.compile_plan(cfg, batch=2, pipeline=False, train=True)
    labels = np.array([3, 7])
    got, _ = T.loss_and_grads(params, images, labels, cfg,
                              backend="kernels", plan=plan, device="cpu")
    want, _ = T.loss_and_grads(params, images, labels, cfg,
                               backend="torch", device="cpu")
    for k in params:
        torch.testing.assert_close(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   msg=k)


# ---------------------------------------------------------------------------
# The ops.* fault sites
# ---------------------------------------------------------------------------

def _site_calls():
    """(site, ops call, the kernel module's own call) on small inputs."""
    t = torch.from_numpy
    x, w = t(_rand(20, 1, 7, 7, 3)), t(_rand(21, 3, 3, 3, 8, scale=0.3))
    b = t(_rand(22, 8, scale=0.1))
    u, wcc = t(_rand(23, 1, 18, 4, scale=0.5)), t(_rand(24, 18, 16, 4))
    uh = t(_rand(25, 1, 18, 16, scale=0.1))
    s = t(_rand(26, 5, 4))
    rkw = dict(iters=3, num_classes=4)
    return {
        faults.SITE_CONV2D: (
            lambda: ops.conv2d(x, w, b, stride=2),
            lambda: conv2d_im2col(x, w, b, stride=2,
                                  block=ops.planned_conv_blocks(9, 27, 8),
                                  dx_block=ops.planned_conv_blocks(
                                      9, 8, 27))),
        faults.SITE_VOTES_ROUTING: (
            lambda: ops.votes_routing(u, wcc, **rkw),
            lambda: k34.votes_routing(u, wcc, mode="resident",
                                      block_i=18, **rkw)),
        faults.SITE_PRIMARY_ROUTING: (
            lambda: ops.primary_routing(x, w, b, wcc, stride=2, **rkw),
            None),
        faults.SITE_CAPS_VOTES: (
            lambda: ops.caps_votes(u, wcc),
            lambda: k14a.caps_votes(u, wcc, block_i=1)),
        faults.SITE_ROUTING: (
            lambda: ops.routing(uh, **rkw),
            lambda: k14b.routing(uh, block_i=18, **rkw)),
        faults.SITE_SQUASH: (
            lambda: ops.squash(s),
            lambda: k10.squash(s)),
    }


@pytest.mark.parametrize("site", sorted(_site_calls()))
def test_ops_fault_site_is_inert_off_and_poisons_on(site):
    call, direct = _site_calls()[site]
    clean = call()
    assert bool(torch.isfinite(clean).all())
    if direct is not None:
        torch.testing.assert_close(clean, direct(), rtol=0, atol=0)
    with faults.inject(faults.FaultSpec(site=site,
                                        kind="nan_output")) as reg:
        poisoned = call()
        assert reg.count(site=site, kind="nan_output") == 1
    assert poisoned.shape == clean.shape
    assert bool(torch.isnan(poisoned).all())
    torch.testing.assert_close(call(), clean, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The ctypes bindings against the C entries they call
# ---------------------------------------------------------------------------

def _c_params(library: str, symbol: str) -> list[str]:
    """Parameter declarations of ``REPRO_EXPORT int symbol(...)`` in
    ``csrc/<library>.cu``, or of the macro ``NAME`` entry that the file
    instantiates as ``symbol``."""
    import re
    from repro_torch.kernels import build
    text = (build.CSRC / f"{library}.cu").read_text().replace("\\", " ")
    assert re.search(r"\b" + symbol + r"\b", text), symbol
    m = (re.search(r"REPRO_EXPORT int " + symbol + r"\((.*?)\)\s*\{", text,
                   re.S)
         or re.search(r"REPRO_EXPORT int NAME\((.*?)\)\s*\{", text, re.S))
    assert m, symbol
    return [p.strip() for p in m.group(1).split(",")]


def test_every_binding_matches_its_c_signature():
    """Each Kernel's argtypes: a pointer for each pointer parameter, a
    64-bit int for ``long long``, a C float for ``float`` and a 32-bit int
    for ``int``, in order."""
    import ctypes
    from repro_torch.kernels import build
    want_type = {"ptr": ctypes.c_void_p, "long long": ctypes.c_longlong,
                 "float": ctypes.c_float, "int": ctypes.c_int}
    for kernel in build.REGISTRY.values():
        params = _c_params(kernel.library, kernel.symbol)
        kinds = ["ptr" if "*" in p else
                 "long long" if p.startswith("long long") else
                 "float" if p.startswith("float") else "int"
                 for p in params]
        assert [want_type[k] for k in kinds] == list(kernel.argtypes), \
            kernel.symbol
