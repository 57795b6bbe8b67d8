"""Deep capsule stacks through the port, against the reference on the CPU.

The SVHN and CIFAR-10 configs and the registry; the kernels backend on
ResCaps stacks (the reversible segment K12) in forward and in every
gradient against the reference's jnp path; the residual-add epilogue of
K3/K4; the unfused oracle schedule K13 (``streamed-2pass``) against the
fused ``streamed`` one, bit for bit; the Hopper plan's ``streamed-global`` mode (the
routing logits in device memory) at full SVHN width, with every MNIST
plan unchanged; and the flat-in-depth activation residency.  Kernel
wrappers run their plain twins on CPU tensors; the card-side checks are
in ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.core import capsnet as R
from repro.core import execplan as ref_execplan
from repro.kernels import ref as ref_k
from repro.kernels import votes_routing as ref_vr
from repro_torch.configs import (capsnet_cifar10, capsnet_mnist,
                                 capsnet_svhn, registry)
from repro_torch.convert import params_from_numpy
from repro_torch.core import capsnet as T
from repro_torch.core import execplan, faults, planner
from repro_torch.core.execplan import (ALL_MODES, CLUSTER_SIZES, MODES,
                                       ORACLE_MODE, PIPE_NAME,
                                       STREAMED_GLOBAL, PlanError,
                                       compile_plan)
from repro_torch.kernels import ops
from repro_torch.kernels import votes_routing as vr
from repro_torch.serve.capsule import CapsRequest, CapsuleEngine
from repro_torch.train import capsnet_loop

TOL = 1e-5
KEYS = ("class_caps", "lengths", "reconstruction")
GOLDEN = Path(__file__).with_name("golden_torch_mnist_plans.json")
# The reference's pipelined deep stack (tests/test_caps_stack.py): 48
# primary capsules, a plain layer of 14 x 6D, then one ResCaps block.
BASE = dict(image_hw=14, conv1_channels=16, conv1_kernel=5, pc_kernel=3,
            num_primary_groups=3, primary_dim=4, class_dim=8,
            use_decoder=False)
PIPELINED = R.CapsNetConfig(**BASE, caps_layers=(R.CapsLayerSpec(14, 6),
                                                 R.ResCapsBlock()))
CASES = {"svhn-smoke": ref_registry.get_smoke_config("capsnet-svhn"),
         "cifar10-smoke": ref_registry.get_smoke_config("capsnet-cifar10"),
         "pipelined-stack": PIPELINED}


def to_port(cfg: R.CapsNetConfig) -> T.CapsNetConfig:
    """The port's config with the same fields as a reference config."""
    layers = tuple(
        T.ResCapsBlock(e.routing_iters) if isinstance(e, R.ResCapsBlock)
        else T.CapsLayerSpec(e.num_caps, e.caps_dim, e.routing_iters)
        for e in cfg.caps_layers)
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg) if f.name != "caps_layers"}
    return T.CapsNetConfig(**fields, caps_layers=layers)


def _rand(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _normalised_err(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """(port cfg, port params, images, labels, reference cfg, the
    reference's jnp forward and its ``jax.grad`` of ``total_loss``)."""
    cfg_r = CASES[request.param]
    params_r = jax.jit(R.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), cfg_r)
    rng = np.random.default_rng(1)
    images = rng.random((2, cfg_r.image_hw, cfg_r.image_hw,
                         cfg_r.in_channels), np.float32)
    labels = rng.integers(0, cfg_r.num_classes, 2)
    x, y = jnp.asarray(images), jnp.asarray(labels)
    want = jax.jit(lambda p: R.forward(p, x, cfg_r))(params_r)
    grads = jax.jit(jax.grad(
        lambda p: R.total_loss(p, x, y, cfg_r)[0]))(params_r)
    params = params_from_numpy({k: np.asarray(v)
                                for k, v in params_r.items()}, "cpu")
    return to_port(cfg_r), params, images, labels, cfg_r, want, grads


# ---------------------------------------------------------------------------
# Configs and registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module,arch", [(capsnet_svhn, "capsnet-svhn"),
                                         (capsnet_cifar10, "capsnet-cifar10")])
def test_configs_match_the_reference(module, arch):
    assert module.config() == to_port(ref_registry.get_config(arch))
    assert module.smoke_config() == to_port(
        ref_registry.get_smoke_config(arch))


PORTED_LM_ARCHS = ("gemma2-9b", "gemma3-12b", "granite-3-2b", "gemma-7b",
                   "chameleon-34b")


def test_registry_matches_the_reference_capsnet_subset():
    assert registry.CAPSNET_ARCHS == ref_registry.CAPSNET_ARCHS
    assert registry.list_archs() == [
        a for a in ref_registry.list_archs()
        if a in ref_registry.CAPSNET_ARCHS or a in PORTED_LM_ARCHS]
    for alias in ("capsnet", "capsnet_mnist", "capsnet_cifar10",
                  "capsnet_svhn", *ref_registry.CAPSNET_ARCHS):
        assert registry.canonical(alias) == ref_registry.canonical(alias)
        assert registry.get_config(alias) == to_port(
            ref_registry.get_config(alias))
        assert registry.get_smoke_config(alias) == to_port(
            ref_registry.get_smoke_config(alias))
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_config("capsnet-imagenet")


@pytest.mark.parametrize("arch", ref_registry.LM_ARCHS)
def test_registry_names_the_roadmap_item_for_lm_archs(arch):
    """The dense LM archs resolve to the reference's configs; the others
    are refused with the ROADMAP item that ports them."""
    if arch in PORTED_LM_ARCHS:
        for get, ref_get in ((registry.get_config, ref_registry.get_config),
                             (registry.get_smoke_config,
                              ref_registry.get_smoke_config)):
            assert dataclasses.asdict(get(arch)) == dataclasses.asdict(
                ref_get(arch))
        return
    with pytest.raises(KeyError, match="item 11"):
        registry.get_config(arch)


# ---------------------------------------------------------------------------
# The kernels backend on deep stacks against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pipeline", [True, False])
def test_forward_kernels_matches_reference_jnp(case, pipeline):
    cfg, params, images, _, cfg_r, want, _ = case
    plan = compile_plan(cfg, batch=2, pipeline=pipeline)
    if cfg_r is PIPELINED and pipeline:
        assert plan.ops[1].name == execplan.PIPE_NAME   # K5 leads the stack
    got = T.forward(params, images, cfg, backend="kernels", plan=plan,
                    device="cpu")
    for k in KEYS:
        if k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=TOL, atol=TOL, err_msg=k)


def test_gradients_through_k12_match_reference_jnp(case):
    """Every parameter's gradient on the kernels backend (the reversible
    segment's backward rebuilds each block's input from its output) is
    within 1e-5 of the reference's ``jax.grad``, normalised by the
    reference's largest magnitude."""
    cfg, params, images, labels, _, _, want = case
    plan = compile_plan(cfg, batch=2, pipeline=True, train=True)
    got, _ = T.loss_and_grads(params, images, labels, cfg,
                              backend="kernels", plan=plan, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert _normalised_err(got[k].numpy(), want[k]) <= TOL, k


def test_kernels_backend_plans_when_no_plan_is_passed():
    cfg = capsnet_svhn.smoke_config()
    params = T.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    images = np.random.default_rng(2).random((3, 16, 16, 3), np.float32)
    got = T.forward(params, images, cfg, backend="kernels", device="cpu")
    want = T.forward(params, images, cfg, backend="torch", device="cpu")
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=TOL, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# The residual-add epilogue (K3/K4 with r)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ALL_MODES)
def test_residual_epilogue_adds_r_on_every_schedule(mode):
    u, w = _rand(1, 2, 27, 4, scale=0.5), _rand(2, 27, 32, 4, scale=0.3)
    r, g = _rand(3, 2, 32), _rand(4, 2, 32)
    kw = dict(iters=3, num_classes=4, mode=mode, block_i=8)
    t = torch.from_numpy
    v = vr.votes_routing_plain(t(u), t(w), **kw)
    torch.testing.assert_close(vr.votes_routing_plain(t(u), t(w), r=t(r),
                                                      **kw),
                               v + t(r), rtol=0, atol=0)
    uu, ww, rr = (t(x).requires_grad_() for x in (u, w, r))
    out = vr.votes_routing(uu, ww, r=rr, bwd_mode=mode, **kw)
    out.backward(t(g))
    du, dw = vr.votes_routing_bwd_plain(t(u), t(w), t(g), **kw)
    torch.testing.assert_close(rr.grad, t(g), rtol=0, atol=0)
    torch.testing.assert_close(uu.grad, du, rtol=0, atol=0)
    torch.testing.assert_close(ww.grad, dw, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["resident", "streamed", ORACLE_MODE])
def test_residual_epilogue_matches_reference_pallas(mode):
    """Against the reference's ``_vr_core_res`` (Pallas, interpret mode):
    the output, and the cotangents of u, W and r (passed through)."""
    u, w = _rand(5, 2, 20, 4, scale=0.5), _rand(6, 20, 24, 4, scale=0.3)
    r, g = _rand(7, 2, 24), _rand(8, 2, 24)
    st = ref_vr._VRStatics(iters=3, num_classes=4, mode=mode, block_i=8,
                           bwd_mode=mode, bwd_block_i=8, interpret=True)
    want, pull = jax.vjp(lambda a, b, c: ref_vr._vr_core_res(st, a, b, c),
                         *map(jnp.asarray, (u, w, r)))
    dwant = pull(jnp.asarray(g))
    uu, ww, rr = (torch.from_numpy(x).requires_grad_() for x in (u, w, r))
    got = vr.votes_routing(uu, ww, r=rr, iters=3, num_classes=4, mode=mode,
                           block_i=8, bwd_mode=mode, bwd_block_i=8)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=1e-6)
    for name, x, y in zip("uwr", (uu, ww, rr), dwant):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(y), rtol=TOL,
                                   atol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# K13: the unfused streamed schedule against the fused one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,i,c,j,d,bi,iters", [
    (1, 64, 8, 10, 16, 32, 3),       # divisible blocks
    (2, 100, 8, 10, 16, 32, 3),      # ragged final i-block + batch>1
    (3, 135, 8, 5, 8, 64, 2),        # batch > 1 + ragged tail
    (2, 27, 4, 4, 8, 8, 1),          # odd non-power-of-two capsule count
    (2, 96, 8, 5, 8, 32, 5),         # deeper iteration count
])
def test_k13_forward_matches_fused_streamed(b, i, c, j, d, bi, iters):
    """The oracle equals the fused kernel bit for bit (both on K4's planned
    cluster), as the reference's two schedules agree; against the jnp
    reference the reference's own cases and tolerances
    (tests/test_votes_routing.py)."""
    u, w = _rand(i + iters, b, i, c, scale=0.5), _rand(i, i, j * d, c,
                                                       scale=0.3)
    kw = dict(iters=iters, num_classes=j, block_i=bi)
    t = torch.from_numpy
    fused = vr.votes_routing(t(u), t(w), mode="streamed", **kw)
    oracle = vr.votes_routing(t(u), t(w), mode=ORACLE_MODE, **kw)
    want = ref_k.routing(ref_k.caps_votes(jnp.asarray(u), jnp.asarray(w))
                         .reshape(b, i, j, d), iters).reshape(b, j * d)
    torch.testing.assert_close(oracle, fused, rtol=0, atol=0)
    np.testing.assert_allclose(oracle.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("b,i,c,j,d,bi,iters", [
    (1, 64, 8, 10, 16, 32, 3),       # divisible blocks
    (2, 100, 8, 10, 16, 32, 3),      # ragged final i-block + batch>1
    (2, 27, 4, 4, 8, 8, 1),          # odd non-power-of-two capsule count
], ids=["even", "ragged", "nonpow2"])
def test_k13_backward_matches_fused_streamed(b, i, c, j, d, bi, iters):
    """The reference's cases (tests/test_grads.py): the oracle's gradients
    equal the fused replay's bit for bit (both on K9's planned cluster),
    and the jnp reference's within its tolerance."""
    u, w = _rand(50 + i, b, i, c, scale=0.5), _rand(i, i, j * d, c, scale=0.3)
    dv = _rand(iters, b, j, d)

    def grads(mode):
        uu, ww = (torch.from_numpy(x).requires_grad_() for x in (u, w))
        v = vr.votes_routing(uu, ww, iters=iters, num_classes=j, mode=mode,
                             block_i=bi, bwd_mode=mode,
                             bwd_block_i=max(bi // 2, 1))
        torch.sum(v.reshape(b, j, d) * torch.from_numpy(dv)).backward()
        return uu.grad.numpy(), ww.grad.numpy()

    def loss_ref(uu, ww):
        uh = R.compute_votes(uu, ww.reshape(i, j, d, c))
        return jnp.sum(R.routing_by_agreement(uh, iters) * dv)

    want = jax.jit(jax.grad(loss_ref, argnums=(0, 1)))(jnp.asarray(u),
                                                       jnp.asarray(w))
    for g_f, g_o, g_r in zip(grads("streamed"), grads(ORACLE_MODE), want):
        np.testing.assert_array_equal(g_o, g_f)
        assert _normalised_err(g_o, g_r) <= TOL


def test_k13_keeps_its_logits_where_streamed_would():
    """K13 takes K4's cluster, placement and footprint at its batch and
    i-tile (the MNIST ClassCaps and the SVHN bottleneck: streamed, the
    logits on chip; a CIFAR-10 full-width half: streamed-global), and
    K13b K9's cluster and footprint."""
    for (i, c, j, d, bi), want in (((1152, 8, 10, 16, 128), "streamed"),
                                   ((2048, 8, 64, 8, 64), "streamed"),
                                   ((1024, 8, 1024, 8, 2),
                                    STREAMED_GLOBAL)):
        u = torch.empty(8, i, c, device="meta")
        w = torch.empty(i, j * d, c, device="meta")
        sched = execplan.plan_votes_routing_cluster(i, c, j * d, j, batch=8,
                                                    votes=want, block_i=bi)
        cs = vr.fwd_cluster(u, w, iters=3, num_classes=j, mode=ORACLE_MODE,
                            cluster=None, block_i=bi)
        assert cs == sched.cluster.cluster
        place = vr.logits_placement(ORACLE_MODE, i, c, j, j * d, cs, bi)
        assert place == want
        assert execplan.votes_routing_cluster_smem(
            i, c, j, j * d, cs, mode=place, block_i=bi) == sched.smem_bytes
    for i, c, j, d, bi in ((1152, 8, 10, 16, 128), (2048, 8, 64, 8, 64)):
        u = torch.empty(16, i, c, device="meta")
        w = torch.empty(i, j * d, c, device="meta")
        sched = execplan.plan_routing_bwd_cluster(i, c, j * d, j, batch=16,
                                                  votes="streamed")
        assert vr.bwd_schedule(u, w, iters=3, num_classes=j,
                               mode=ORACLE_MODE, cluster=None) == (
            ORACLE_MODE, sched.cluster.cluster)


# ---------------------------------------------------------------------------
# The Hopper plan: streamed-global at full SVHN width, MNIST unchanged
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train,batch", [(False, 8), (True, 16)])
@pytest.mark.parametrize("pipeline", [True, False])
def test_full_width_svhn_plans_within_one_cta(train, batch, pipeline):
    cfg = capsnet_svhn.config()
    plan = compile_plan(cfg, batch=batch, pipeline=pipeline, train=train)
    # K5 splits the bottleneck's 524 KB of logits over a cluster, so the
    # pipelined plan exists, as the reference's does.
    assert plan.pipelined == pipeline
    assert all(0 < op.smem_bytes <= planner.SMEM_BYTES == 232_448
               for op in plan.ops)
    if pipeline:
        pr = plan.op(PIPE_NAME)
        assert (pr.mode, pr.n_passes) == ("streamed", 4)
        assert pr.cluster in (8, 16) and pr.block.rows * pr.cluster == 2048
    else:
        # K4 streams the bottleneck's votes on a cluster whose CTAs hold
        # their rows' logits (256 rows x 64 at 8 CTAs).
        neck = plan.op("ClassCaps-Routing[0]")
        assert (neck.mode, neck.block_i, neck.n_passes) == ("streamed", 64,
                                                            4)
        assert neck.cluster in (4, 8, 16)
        assert neck.smem_bytes == execplan.votes_routing_cluster_smem(
            2048, 8, 64, 512, neck.cluster, mode="streamed", block_i=64)
    # The ResCaps halves (32 -> 32x8) and ClassCaps (64 -> 10x16): K3,
    # resident votes on a cluster (tests/test_torch_k3k8_cluster.py).
    for name, i_dim, j, jd in [(f"ClassCaps-Routing[{k}]", 32, 32, 256)
                               for k in range(1, 5)] + [
                                   ("ClassCaps-Routing", 64, 10, 160)]:
        op = plan.op(name)
        assert (op.mode, op.smem_bytes) == (
            "resident", execplan.votes_routing_cluster_smem(
                i_dim, 8, j, jd, op.cluster))
    if train:
        # K9 replays the bottleneck on a cluster with the logits on chip.
        nbwd = plan.op("ClassCaps-Routing[0]-bwd")
        assert (nbwd.mode, nbwd.n_passes, nbwd.cluster) == ("streamed", 5,
                                                            16)
        assert nbwd.smem_bytes == execplan.routing_bwd_cluster_smem(
            "streamed", 2048, nbwd.block_i, 8, 64, 512, 16)


def test_streamed_global_drops_only_the_logits_and_adds_their_traffic():
    i, c, j, jd, bi = 2048, 8, 64, 512, 64
    # K13 keeps its logits in device memory only on a cluster whose CTAs'
    # share of them does not fit (one CTA: 2048 rows x 64), as K4g does.
    assert [vr.logits_placement(ORACLE_MODE, i, c, j, jd, cs, bi)
            for cs in (1, 2, 8, 16)] == [STREAMED_GLOBAL, STREAMED_GLOBAL,
                                         "streamed", "streamed"]
    base = execplan.votes_routing_global_bytes(8, i, c, jd, 4)
    assert execplan.votes_routing_global_bytes(8, i, c, jd, 4, j) - base \
        == 8 * 2 * 4 * i * j * 4
    # On K4's cluster only the CTA's rows' logits leave.
    for cs in (1, 8, 16):
        rows = -(-i // cs)
        assert (execplan.votes_routing_cluster_smem(
            i, c, j, jd, cs, mode="streamed", block_i=bi)
            - execplan.votes_routing_cluster_smem(
                i, c, j, jd, cs, mode=STREAMED_GLOBAL, block_i=bi)
            == rows * j * 4)
    # Where the logits fit a cluster CTA, the plan keeps them on chip.
    assert execplan.plan_votes_routing(i, c, jd, j, batch=8).mode \
        == "streamed"
    with pytest.raises(PlanError, match=STREAMED_GLOBAL):
        execplan.plan_votes_routing(2048, 8, 512, 64, smem_budget=14_000)


def test_full_width_cifar10_training_plan_names_the_bwd_op():
    """A half of 1024 capsules routed to 1024 x 8D: the forward plans in
    streamed-global on a cluster (even 16 CTAs' rows' logits, 64 x 1024,
    fit no CTA), but the backward's emit CTA (W[i] and dW[i], 2 x 256 KB)
    fits no CTA: the error names the ``-bwd`` op."""
    plan = compile_plan(capsnet_cifar10.config(), batch=8)
    op = plan.op("ClassCaps-Routing[0]")
    assert op.mode == STREAMED_GLOBAL and op.cluster in CLUSTER_SIZES
    assert op.smem_bytes == execplan.votes_routing_cluster_smem(
        1024, 8, 1024, 8192, op.cluster, mode=STREAMED_GLOBAL,
        block_i=op.block_i) <= planner.SMEM_BYTES
    with pytest.raises(PlanError, match=r"ClassCaps-Routing\[5\]-bwd"):
        compile_plan(capsnet_cifar10.config(), batch=8, train=True)


def _golden() -> dict:
    return json.loads(GOLDEN.read_text())


@pytest.mark.parametrize("key", sorted(_golden()))
def test_mnist_plans_are_unchanged(key):
    """Op by op (tiles, modes, footprints, modeled bytes), the MNIST plans
    equal those ``compile_plan`` gave before the streamed-global mode."""
    name, pipeline, train, batch = key.split()
    cfg = {"mnist": capsnet_mnist.config(),
           "smoke": capsnet_mnist.smoke_config()}[name]
    plan = compile_plan(cfg, batch=int(batch.split("=")[1]),
                        pipeline=pipeline == "pipeline=True",
                        train=train == "train=True")
    got = json.loads(json.dumps([dataclasses.astuple(op)
                                 for op in plan.ops]))
    assert got == _golden()[key]


def test_oracle_mode_is_never_plan_chosen():
    assert ORACLE_MODE not in MODES and ORACLE_MODE in ALL_MODES
    assert vr.MODES == MODES and vr.ALL_MODES == ALL_MODES
    assert vr.ORACLE_MODE == ref_vr.ORACLE_MODE == ORACLE_MODE
    plans = [compile_plan(cfg, batch=8, train=True) for cfg in (
        T.CapsNetConfig(), capsnet_svhn.config(),
        capsnet_cifar10.smoke_config())]
    for plan in plans:
        assert all(op.mode in MODES for op in plan.ops if op.mode)
    plan = plans[1]
    ops_ = tuple(dataclasses.replace(op, mode=ORACLE_MODE)
                 if op.name == "ClassCaps-Routing[0]" else op
                 for op in plan.ops)
    with pytest.raises(PlanError, match="oracle"):
        dataclasses.replace(plan, ops=ops_).validate()


# ---------------------------------------------------------------------------
# K12: what it saves, its checks, its fault site; residency flat in depth
# ---------------------------------------------------------------------------

def _segment(n_blocks=2, i_dim=11, c=4, bsz=2, seed=10):
    i1 = i_dim // 2
    x = torch.from_numpy(_rand(seed, bsz, i_dim, c, scale=0.5))
    ws = []
    for k in range(n_blocks):
        ws += [torch.from_numpy(_rand(seed + 2 * k + 1, i_dim - i1, i1 * c, c,
                                      scale=0.3)),
               torch.from_numpy(_rand(seed + 2 * k + 2, i1, (i_dim - i1) * c,
                                      c, scale=0.3))]
    st_f = (3, i1, "resident", 8, "resident", 8)
    st_g = (3, i_dim - i1, "resident", 8, "resident", 8)
    blocks = tuple((i1, st_f, st_g) for _ in range(n_blocks))
    return x, ws, blocks


def test_k12_saves_only_the_output_and_the_weights():
    x, ws, blocks = _segment()
    x.requires_grad_()
    ws = [w.requires_grad_() for w in ws]
    y = vr.res_caps_segment(x, ws, blocks=blocks)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 1 + len(ws)
    assert torch.equal(saved[0], y)
    assert all(s.data_ptr() == w.data_ptr() for s, w in zip(saved[1:], ws))
    y.sum().backward()
    assert x.grad is not None and all(w.grad is not None for w in ws)


def test_k12_rejects_bad_blocks_and_weights():
    x, ws, blocks = _segment()
    with pytest.raises(ValueError, match="half-weights"):
        vr.res_caps_segment(x, ws[:3], blocks=blocks)
    with pytest.raises(ValueError, match="split"):
        vr.res_caps_segment(x, ws, blocks=((11,) + blocks[0][1:],
                                           blocks[1]))
    with pytest.raises(ValueError, match="weight shapes"):
        vr.res_caps_segment(x, [ws[1], ws[0]] + ws[2:], blocks=blocks)
    bad = ((5, (3, 5, "fused", 8, None, None), blocks[0][2]), blocks[1])
    with pytest.raises(ValueError, match="unknown mode"):
        vr.res_caps_segment(x, ws, blocks=bad)


def test_res_caps_segment_fault_site_is_inert_off_and_poisons_on():
    cfg = capsnet_cifar10.smoke_config()
    stack = cfg.routing_stack()
    pairs = tuple((stack[k], stack[k + 1]) for k in range(0, 6, 2))
    ws = [torch.from_numpy(_rand(30 + n, lay.in_caps, lay.jd, lay.in_dim,
                                 scale=0.3))
          for n, lay in enumerate(stack[:6])]
    x = torch.from_numpy(_rand(29, 2, cfg.num_primary, cfg.primary_dim))
    clean = ops.res_caps_segment(x, ws, pairs)
    assert bool(torch.isfinite(clean).all())
    site = faults.SITE_RES_CAPS_SEGMENT
    with faults.inject(faults.FaultSpec(site=site,
                                        kind="nan_output")) as reg:
        poisoned = ops.res_caps_segment(x, ws, pairs)
        assert reg.count(site=site, kind="nan_output") == 1
    assert bool(torch.isnan(poisoned).all())
    torch.testing.assert_close(ops.res_caps_segment(x, ws, pairs), clean,
                               rtol=0, atol=0)
    plan = compile_plan(cfg, batch=1)
    with pytest.raises(ValueError, match="exceeds the plan's batch"):
        ops.res_caps_segment(x, ws, pairs, plan=plan)


@pytest.mark.parametrize("arch", ref_registry.CAPSNET_ARCHS)
def test_activation_residency_matches_reference(arch):
    cfg_r = ref_registry.get_config(arch)
    plan = compile_plan(to_port(cfg_r), batch=4)
    for reversible in (True, False):
        want = ref_execplan.activation_residency_bytes(
            cfg_r, batch=4, reversible=reversible)
        assert execplan.activation_residency_bytes(
            to_port(cfg_r), batch=4, reversible=reversible) == want
        assert plan.activation_residency_bytes(reversible=reversible) == want


def test_activation_residency_is_flat_in_depth_when_reversible():
    def cfg(n):
        return dataclasses.replace(capsnet_cifar10.smoke_config(),
                                   caps_layers=(T.ResCapsBlock(),) * n)
    rev = [execplan.activation_residency_bytes(cfg(n), batch=4)
           for n in (1, 2, 4)]
    naive = [execplan.activation_residency_bytes(cfg(n), batch=4,
                                                 reversible=False)
             for n in (1, 2, 4)]
    assert rev[0] == rev[1] == rev[2]
    assert naive[0] < naive[1] < naive[2]


# ---------------------------------------------------------------------------
# Entry points on a deep stack: the engine and the training CLI
# ---------------------------------------------------------------------------

def test_engine_serves_a_deep_stack():
    cfg = capsnet_svhn.smoke_config()
    params = T.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    images = np.random.default_rng(3).random((5, 16, 16, 3), np.float32)
    engine = CapsuleEngine(params, cfg, slots=4, backend="kernels",
                           device="cpu")
    for n, img in enumerate(images):
        engine.submit(CapsRequest(rid=n, image=img))
    done = sorted(engine.run(), key=lambda r: r.rid)
    assert [r.status for r in done] == ["ok"] * 5
    want = T.forward(params, images, cfg, backend="torch", device="cpu")
    np.testing.assert_allclose(np.stack([r.lengths for r in done]),
                               want["lengths"].numpy(), rtol=TOL, atol=1e-6)


def test_training_cli_takes_a_deep_arch(tmp_path, capsys):
    assert capsnet_loop.main([
        "--arch", "capsnet-cifar10", "--smoke", "--device", "cpu",
        "--steps", "2", "--batch", "2", "--ckpt-dir", str(tmp_path),
        "--no-resume"]) == 0
    assert "over 2 steps" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        capsnet_loop.main(["--arch", "gemma2-9b", "--device", "cpu"])
