"""Training through the port against the reference, on the CPU.

Gradients of ``total_loss`` on ``backend="kernels"`` (whose wrappers run
their plain twins on CPU tensors, backward included) against
``jax.grad`` of the reference's ``total_loss(backend="jnp")``; the
training plan's backward ops; AdamW, checkpoints, data, fault injection
and ``CapsTrainLoop``.  Inputs are made with numpy from a seed, weights
carried across by ``repro_torch.convert``.  Gradient tolerance: rtol
1e-5, atol 1e-6, the reference's own.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import capsnet_mnist as ref_mnist
from repro.core import capsnet as R
from repro.core import execplan as ref_execplan
from repro.train import checkpoint as ref_ckpt
from repro.train import data as ref_data
from repro.train import optimizer as ref_opt
from repro_torch.configs import capsnet_mnist
from repro_torch.convert import opt_state_from_numpy, params_from_numpy
from repro_torch.core import capsnet as T
from repro_torch.core import execplan, faults, planner
from repro_torch.core.execplan import BWD_SUFFIX, FUSED_NAME, PlanError
from repro_torch.kernels import ops
from repro_torch.kernels import votes_routing as k34
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import data, optimizer
from repro_torch.train.capsnet_loop import (SMOKE, CapsLoopConfig,
                                            CapsTrainLoop, main)

BATCH = 4


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@pytest.fixture(scope="module")
def smoke():
    cfg_r = ref_mnist.smoke_config()
    params_r = R.init_params(jax.random.PRNGKey(0), cfg_r)
    rng = np.random.default_rng(0)
    images = rng.random((BATCH, 14, 14, 1), np.float32)
    labels = np.array([3, 7, 0, 9])

    def loss_r(p):
        return R.total_loss(p, jnp.asarray(images), jnp.asarray(labels),
                            cfg_r, backend="jnp")

    (loss, _), grads = jax.jit(jax.value_and_grad(loss_r, has_aux=True))(
        params_r)
    return dict(cfg=capsnet_mnist.smoke_config(), params_np=_np(params_r),
                images=images, labels=labels, loss=float(loss),
                grads=_np(grads))


# ---------------------------------------------------------------------------
# Gradients (fault 1 and fault 2 of the first slice)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pipeline", [True, False])
def test_kernels_backend_gradients_match_jax(smoke, pipeline):
    """Every parameter's gradient of ``total_loss`` through the kernels
    equals ``jax.grad`` of the reference's plain loss.  Autograd through
    the forward twins once broke the routing's stop-gradient convention
    (errors of 4-6% on ``cc_w``, ``pc_w``, ``conv1_w``)."""
    cfg = smoke["cfg"]
    params = params_from_numpy(smoke["params_np"], "cpu")
    plan = execplan.compile_plan(cfg, batch=BATCH, pipeline=pipeline,
                                 train=True)
    grads, metrics = T.loss_and_grads(params, smoke["images"],
                                      smoke["labels"], cfg,
                                      backend="kernels", plan=plan,
                                      device="cpu")
    assert metrics["loss"].item() == pytest.approx(smoke["loss"], rel=1e-5)
    assert set(grads) == set(smoke["grads"])
    for k, want in smoke["grads"].items():
        np.testing.assert_allclose(grads[k].numpy(), want, rtol=1e-5,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("pipeline", [None, True, False])
def test_kernels_backend_gives_every_parameter_a_finite_gradient(smoke,
                                                                 pipeline):
    """``backward()`` leaves no parameter without a gradient (on the card
    the wrappers' outputs once had no ``grad_fn``)."""
    cfg = smoke["cfg"]
    params = {k: v.requires_grad_() for k, v in
              params_from_numpy(smoke["params_np"], "cpu").items()}
    plan = (None if pipeline is None else execplan.compile_plan(
        cfg, batch=BATCH, pipeline=pipeline, train=True))
    loss, _ = T.total_loss(params, smoke["images"], smoke["labels"], cfg,
                           backend="kernels", plan=plan, device="cpu")
    loss.backward()
    for k, p in params.items():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), k


def test_train_step_matches_reference(smoke):
    cfg = smoke["cfg"]
    params = params_from_numpy(smoke["params_np"], "cpu")
    T.train_step(params, smoke["images"], smoke["labels"], cfg, lr=0.05,
                 backend="kernels", device="cpu")
    for k, p in params.items():
        np.testing.assert_allclose(
            p.numpy(), smoke["params_np"][k] - 0.05 * smoke["grads"][k],
            rtol=1e-5, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# The training plan
# ---------------------------------------------------------------------------

CONFIGS = {"mnist": (capsnet_mnist.config(), ref_mnist.config()),
           "smoke": (capsnet_mnist.smoke_config(), ref_mnist.smoke_config())}


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("pipeline", [True, False])
def test_train_plan_appends_bwd_ops_in_reverse_order(name, pipeline):
    cfg, cfg_r = CONFIGS[name]
    plan = execplan.compile_plan(cfg, batch=16, pipeline=pipeline,
                                 train=True)
    want = [op.name for op in ref_execplan.compile_plan(
        cfg_r, batch=16, pipeline=pipeline, train=True).ops]
    assert [op.name for op in plan.ops] == want
    fwd = execplan.compile_plan(cfg, batch=16, pipeline=pipeline)
    assert not fwd.train and plan.ops[:len(fwd.ops)] == fwd.ops
    assert [op.name for op in plan.ops[len(fwd.ops):]] == [
        FUSED_NAME + BWD_SUFFIX, "PrimaryCaps" + BWD_SUFFIX,
        "Conv1" + BWD_SUFFIX]
    for op in plan.ops:
        assert 0 < op.smem_bytes <= planner.SMEM_BYTES, op.name
    pc = plan.bwd_op("PrimaryCaps")
    assert pc.kernel == "conv_im2col_bwd" and pc.dx_block is not None
    assert fwd.bwd_op("PrimaryCaps") is None


def test_full_width_backward_streams_because_resident_cannot_fit():
    """One MNIST sample's votes (737,280 B) exceed a CTA, so the routing
    backward (K9) replays each sample on a cluster, where each CTA's rows'
    votes fit; its footprint is the kernel's layout."""
    plan = execplan.compile_plan(capsnet_mnist.config(), batch=16,
                                 pipeline=True, train=True)
    bwd = plan.op(FUSED_NAME + BWD_SUFFIX)
    assert (bwd.kernel, bwd.mode, bwd.block_i, bwd.n_passes,
            bwd.cluster) == ("votes_routing_bwd", "resident", 144, 1, 8)
    assert execplan.votes_routing_cluster_smem(
        1152, 8, 10, 160, 1) > planner.SMEM_BYTES
    # 144 votes rows (161 floats each) with their couplings, the rows' u
    # and logits, and 7 [J*D] vectors.
    assert bwd.smem_bytes == 4 * (144 * (161 + 10) + 144 * (8 + 10)
                                  + 7 * 160) == 113_344
    smoke = execplan.compile_plan(SMOKE, batch=16, train=True)
    assert smoke.op(FUSED_NAME + BWD_SUFFIX).mode == "resident"


def test_bwd_plan_error_names_the_bwd_op():
    # Under 20,000 B no backward fits: the emit CTA alone (W[i], dW[i] and
    # a chunk of 16 samples' rows) needs 22,272 B.
    assert execplan.routing_bwd_emit_smem(8, 10, 160) == 22_272
    with pytest.raises(PlanError, match=FUSED_NAME + BWD_SUFFIX):
        execplan.plan_votes_routing_bwd(1152, 8, 160, 10,
                                        smem_budget=20_000)
    # A budget where the forward fits but the backward does not: 64-D class
    # capsules make the emit CTA (83,712 B) larger than every forward op.
    wide = dataclasses.replace(capsnet_mnist.config(), class_dim=64)
    assert execplan.routing_bwd_emit_smem(8, 10, 640) == 83_712
    assert execplan.compile_plan(wide, batch=2, smem_budget=80_000)
    with pytest.raises(PlanError, match=FUSED_NAME + BWD_SUFFIX):
        execplan.compile_plan(wide, batch=2, smem_budget=80_000,
                              train=True)


def test_routing_bwd_global_bytes_count_the_logits_not_the_votes():
    b, i, c, jd, j = 16, 1152, 8, 160, 10
    got = execplan.votes_routing_bwd_global_bytes(b, i, c, jd, j, 5)
    uhat = b * i * jd * 4
    assert got < 3 * uhat + 2 * 5 * i * jd * c * 4 * b
    assert got - execplan.votes_routing_bwd_global_bytes(b, i, c, jd, j,
                                                         4) \
        == b * i * jd * c * 4                  # one more W stream a sample


def test_forward_alone_plans_no_routing_backward():
    """Serving runs the forward under ``no_grad``: the routing backward's
    schedule is planned (and memoized, bounded) only when it runs."""
    k34.planned_votes_routing_bwd.cache_clear()
    u = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 16, 4), np.float32))
    w = torch.zeros(16, 20, 4, requires_grad=True)
    with torch.no_grad():
        ops.votes_routing(u, w, num_classes=5)
    assert k34.planned_votes_routing_bwd.cache_info().currsize == 0
    ops.votes_routing(u, w, num_classes=5).sum().backward()
    assert k34.planned_votes_routing_bwd.cache_info().currsize == 1
    assert w.grad is not None and torch.isfinite(w.grad).all()
    assert k34.planned_votes_routing_bwd.cache_info().maxsize == 64


def test_infeasible_routing_backward_raises_naming_the_bwd_op():
    """No backward schedule fits 16000 capsules routed to 100 classes: in
    one CTA their u alone, 256,000 B, is over the budget, and even split
    over a 16-CTA cluster each CTA's 1000 rows of logits take 400,000 B.
    The forward runs (its logits in global memory on a cluster) and the
    backward raises the planner's PlanError for the ``-bwd`` op, with no
    fallback."""
    u = torch.zeros(1, 16000, 4)
    w = torch.zeros(16000, 200, 4, requires_grad=True)
    v = k34.votes_routing(u, w, num_classes=100,
                          mode=execplan.STREAMED_GLOBAL, block_i=128,
                          op_name="Hidden-Routing")
    with pytest.raises(PlanError, match="Hidden-Routing" + BWD_SUFFIX):
        v.sum().backward()


# ---------------------------------------------------------------------------
# Optimizer, checkpoints, data, faults
# ---------------------------------------------------------------------------

def test_adamw_and_lr_match_reference_over_three_steps():
    cfg_kw = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=5,
                  weight_decay=0.01, clip_norm=0.5)
    rng = np.random.default_rng(3)
    p_np = {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}
    g_np = [{k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in p_np.items()} for _ in range(3)]
    p_r = {k: jnp.asarray(v) for k, v in p_np.items()}
    s_r = ref_opt.init_opt_state(p_r)
    params = params_from_numpy(p_np, "cpu")
    state = opt_state_from_numpy(jax.tree_util.tree_map(np.asarray, s_r),
                                 "cpu")
    for g in g_np:
        p_r, s_r, m_r = ref_opt.adamw_update(
            p_r, {k: jnp.asarray(v) for k, v in g.items()}, s_r,
            ref_opt.OptConfig(**cfg_kw))
        params, state, m = optimizer.adamw_update(
            params, params_from_numpy(g, "cpu"), state,
            optimizer.OptConfig(**cfg_kw))
        assert float(m["lr"]) == pytest.approx(float(m_r["lr"]), rel=1e-6)
        assert float(m["grad_norm"]) == pytest.approx(
            float(m_r["grad_norm"]), rel=1e-6)
        for k in p_np:
            np.testing.assert_allclose(params[k].numpy(), np.asarray(p_r[k]),
                                       rtol=1e-5, atol=1e-6)
            np.testing.assert_allclose(state["v"][k].numpy(),
                                       np.asarray(s_r["v"][k]), rtol=1e-5,
                                       atol=1e-7)
    assert int(state["step"]) == int(s_r["step"]) == 3
    for step in (0, 1, 2, 3, 5, 9):
        assert float(optimizer.lr_at(step, optimizer.OptConfig(**cfg_kw))) \
            == pytest.approx(float(ref_opt.lr_at(
                jnp.asarray(step), ref_opt.OptConfig(**cfg_kw))), rel=1e-6)


def _state():
    params = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "b": torch.ones(3)}
    return {"params": params, "opt": optimizer.init_opt_state(params)}


def test_checkpoint_save_restore_roundtrip(tmp_path):
    state = _state()
    state["opt"]["step"] = torch.tensor(7, dtype=torch.int32)
    ckpt.save(state, tmp_path, 7, extra={"backend": "kernels"})
    state["params"]["w"].add_(1.0)            # the loop updates in place
    template = _state()
    restored, manifest = ckpt.restore(template, tmp_path)
    assert manifest["step"] == 7 and manifest["extra"] == {
        "backend": "kernels"}
    torch.testing.assert_close(restored["params"]["w"],
                               state["params"]["w"] - 1.0)
    assert restored["opt"]["step"].dtype == torch.int32
    assert int(restored["opt"]["step"]) == 7
    assert ckpt.committed_steps(tmp_path) == [7]


def test_restores_a_checkpoint_the_reference_wrote(tmp_path):
    p_np = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": np.ones(3, np.float32)}
    tree = {"params": {k: jnp.asarray(v) for k, v in p_np.items()}}
    tree["opt"] = ref_opt.init_opt_state(tree["params"])
    ref_ckpt.save(tree, tmp_path, 3)
    restored, manifest = ckpt.restore(_state(), tmp_path)
    assert manifest["step"] == 3
    for k, v in p_np.items():
        np.testing.assert_array_equal(restored["params"][k].numpy(), v)
    # ...and the reference reads the port's, key for key.
    ckpt.save(_state(), tmp_path / "port", 4)
    back, _ = ref_ckpt.restore(tree, tmp_path / "port")
    np.testing.assert_array_equal(np.asarray(back["params"]["w"]),
                                  p_np["w"])
    manifest = json.loads((tmp_path / "port" / "step_00000004"
                           / "manifest.json").read_text())
    assert "['opt']['m']['w']" in manifest["keys"]


def test_async_checkpointer_keeps_the_newest(tmp_path):
    saver = ckpt.AsyncCheckpointer(tmp_path, keep=2)
    state = _state()
    for step in (1, 2, 3):
        saver.save_async(state, step)
    saver.wait()
    assert ckpt.committed_steps(tmp_path) == [2, 3]
    assert ckpt.latest_step(tmp_path) == 3


def test_mnist_images_match_reference_from_the_same_draws():
    cfg = ref_data.DataConfig(kind="mnist", global_batch=6, seed=2)
    want = ref_data.mnist_batch(cfg, step=5, channels=3)
    k1, k2 = jax.random.split(ref_data._fold(2, 5, 0))
    labels = np.asarray(jax.random.randint(k1, (6,), 0, 10))
    noise = np.asarray(jax.random.uniform(k2, (6, 28, 28)))
    np.testing.assert_array_equal(labels, np.asarray(want["labels"]))
    np.testing.assert_allclose(data.blobs(labels, noise, channels=3),
                               np.asarray(want["images"]), rtol=1e-5,
                               atol=1e-6)
    got = data.mnist_batch(data.DataConfig(global_batch=6, seed=2), 5)
    again = data.mnist_batch(data.DataConfig(global_batch=6, seed=2), 5)
    assert got["images"].shape == (6, 28, 28, 1)
    np.testing.assert_array_equal(got["images"], again["images"])


def test_fault_injection_is_scoped_and_deterministic():
    spec = faults.FaultSpec(site=faults.SITE_CONV2D, kind="nan_output",
                            at=1)
    x = torch.ones(3)
    assert faults.corrupt_array(faults.SITE_CONV2D, x) is x
    with faults.inject(spec) as reg:
        assert faults.corrupt_array(faults.SITE_CONV2D, x) is x
        assert torch.isnan(faults.corrupt_array(faults.SITE_CONV2D,
                                                x)).all()
        with pytest.raises(faults.InjectionError):
            with faults.inject(spec):
                pass
        assert reg.count(kind="nan_output") == 1
    assert not faults.enabled()
    with faults.inject(faults.FaultSpec(site="ops.conv2d",
                                        kind="plan_error")):
        with pytest.raises(PlanError):
            faults.corrupt_array("ops.conv2d", x)
    with pytest.raises(faults.InjectionError):
        faults.FaultSpec(site="x", kind="meltdown")


# ---------------------------------------------------------------------------
# CapsTrainLoop
# ---------------------------------------------------------------------------

def _loop(tmp_path, total=8, backend="kernels", batch=8, **kw):
    return CapsTrainLoop(SMOKE, CapsLoopConfig(
        total_steps=total, batch=batch, ckpt_every=4,
        ckpt_dir=str(tmp_path / "ck"), log_every=1000, backend=backend,
        heartbeat_path=str(tmp_path / "hb.json"), **kw), device="cpu")


def test_kernels_backend_20_steps_loss_decreases(tmp_path):
    """20 SGD steps at batch 16 through the kernels' CPU twins: the loss
    falls and no NaN rollback fires."""
    loop = _loop(tmp_path, total=20, batch=16)
    assert loop.plan is not None and loop.plan.train
    hist = loop.run()
    assert len(hist) == 20 and loop.nan_skips == 0
    losses = [h["loss"] for h in hist]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-3:]) < np.mean(losses[:3])
    assert 20 in ckpt.committed_steps(tmp_path / "ck")
    assert json.loads((tmp_path / "hb.json").read_text())["step"] == 20


def test_nan_guard_rolls_back_and_skips_the_batch(tmp_path):
    loop = _loop(tmp_path, total=6)
    inner = loop._step_fn
    calls = {"n": 0}

    def poisoned(params, images, labels):
        calls["n"] += 1
        params, metrics = inner(params, images, labels)
        if calls["n"] == 3:
            metrics = dict(metrics, loss=torch.tensor(float("nan")))
        return params, metrics

    loop._step_fn = poisoned
    hist = loop.run()
    assert loop.nan_skips == 1 and loop.step == 6
    assert 3 not in [h["step"] for h in hist]
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_injected_step_fault_and_resume(tmp_path):
    with faults.inject(faults.FaultSpec(site=faults.SITE_TRAIN_STEP,
                                        kind="inf_output", at=1)):
        loop = _loop(tmp_path, total=4, optimizer="adam")
        loop.run()
    assert loop.nan_skips == 1
    loop2 = _loop(tmp_path, total=6, optimizer="adam")
    hist = loop2.run(resume=True)
    assert hist[0]["step"] == 5 and loop2.step == 6
    assert "lr" in hist[0]


def test_cli_assert_improves(tmp_path, capsys):
    rc = main(["--steps", "12", "--batch", "16", "--device", "cpu",
               "--ckpt-dir", str(tmp_path / "ck"), "--assert-improves",
               "--no-resume"])
    assert rc == 0
    assert "median step" in capsys.readouterr().out
