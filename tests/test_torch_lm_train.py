"""LM training through the port against the reference, on the CPU.

``cross_entropy`` and ``lm_loss`` (values and ``jax.grad`` gradients, fp32
compute) on the granite-3-2b, gemma2-9b (softcaps, local/global, post
norms) and phi3.5-moe smoke configs; the low-precision RMSNorm's custom
backward in bf16; the three remat modes; ``make_train_step`` against the
reference's step in fp32 and in bf16; AdamW over a tree with lists;
checkpoints of LM trees keyed as the reference keys them; the LM data
stream; and ``TrainLoop``'s run, resume, preemption, NaN rollback and
straggler hook (the counterparts of ``tests/test_training.py``).

Parameters come from the reference's ``init_model`` through
``convert.lm_params_from_numpy``; tokens are seeded numpy arrays fed to
both sides.  Tolerances, each with its reason:
  * fp32 losses rtol 1e-6; gradients 1e-5 of each leaf's largest value
    (ROADMAP's ground rule; measured <= 3e-6);
  * the fp32 train step: m, v and the grad norm as the gradients; a
    parameter whose gradient is at least 1e-4 of its leaf's largest
    within 1e-5 lr + 2 ulp of the reference's (the update lr * u rounds
    onto p); every parameter within 2.1 lr (the first AdamW step moves p
    by lr * g / (|g| + 1e-8): where g is within the gradient tolerance of
    0 its step may take either sign);
  * bf16 compute: XLA on the CPU keeps fused elementwise chains in fp32
    where torch rounds each op to bf16, so the bf16 step's loss is held to
    rtol 1e-2 and its grad norm to 5e-2 (separately stated, looser);
  * the bf16 RMSNorm backward: bit for bit (measured equal);
  * remat: identical bits (recomputation replays the same ops).
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.launch import steps as ref_steps
from repro.models import init_model as ref_init
from repro.models import transformer as R
from repro.models.layers import _rmsnorm_lowp
from repro.train import checkpoint as ref_ckpt
from repro.train import data as ref_data
from repro.train import optimizer as ref_opt
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.convert import lm_params_from_numpy, opt_state_from_numpy
from repro_torch.launch import steps
from repro_torch.models import transformer as T
from repro_torch.models.layers import RMSNormLowp
from repro_torch.parallel.sharding import ShardingCtx
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import data, optimizer
from repro_torch.train.loop import LoopConfig, TrainLoop

ARCHS = ("granite-3-2b", "gemma2-9b", "phi3.5-moe-42b-a6.6b")
GRAD = 1e-5
OPT = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=50)


def _np(t):
    return jax.tree_util.tree_map(np.asarray, t)


@functools.lru_cache(maxsize=None)
def _params(arch):
    """(reference params, port config) of ``arch``'s smoke model."""
    return ref_init(jax.random.PRNGKey(0), ref_smoke(arch)), \
        registry.get_smoke_config(arch)


def _port_params(arch):
    return lm_params_from_numpy(_np(_params(arch)[0]), "cpu")


def _batch(cfg, b=2, t=12, seed=0, mask=False):
    rng = np.random.default_rng(seed)
    out = {"inputs": rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32),
           "targets": rng.integers(0, cfg.vocab_size, (b, t)).astype(
               np.int32)}
    if mask:
        out["mask"] = (rng.random((b, t)) < 0.6).astype(np.float32)
    return out


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close_leaves(got, want, tol=GRAD):
    """Each leaf within ``tol`` of its largest reference value."""
    got, want = tree.leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        g = g.detach().float().numpy()
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1e-30)


# ---------------------------------------------------------------------------
# Losses and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mask", [False, True])
def test_cross_entropy_matches_reference(mask):
    rng = np.random.default_rng(1)
    logits = (3 * rng.standard_normal((3, 5, 40))).astype(np.float32)
    targets = rng.integers(0, 40, (3, 5)).astype(np.int32)
    m = (rng.random((3, 5)) < 0.5).astype(np.float32) if mask else None
    want = R.cross_entropy(jnp.asarray(logits), jnp.asarray(targets),
                           None if m is None else jnp.asarray(m))
    got = T.cross_entropy(torch.from_numpy(logits), targets, m)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    if mask:        # an all-zero mask divides by max(0, 1)
        zero = T.cross_entropy(torch.from_numpy(logits), targets,
                               np.zeros((3, 5), np.float32))
        assert float(zero) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_gradients_match_jax_grad(arch):
    rp, cfg = _params(arch)
    batch = _batch(cfg, mask=True)
    (want, wm), wg = jax.jit(jax.value_and_grad(
        lambda p: R.lm_loss(p, _jnp(batch), ref_smoke(arch)),
        has_aux=True))(rp)
    tp = tree.tree_map(lambda p: p.requires_grad_(), _port_params(arch))
    loss, metrics = T.lm_loss(tp, batch, cfg)
    grads = torch.autograd.grad(loss, tree.leaves(tp))
    for k in ("loss", "ce", "aux"):
        np.testing.assert_allclose(float(metrics[k].detach()), float(wm[k]),
                                   rtol=1e-6, atol=1e-9)
    assert (float(metrics["aux"]) > 0) == (cfg.moe is not None)
    _close_leaves(grads, wg)


def test_rmsnorm_lowp_matches_the_reference_custom_vjp_in_bf16():
    rng = np.random.default_rng(0)
    x, dy = rng.standard_normal((2, 4, 7, 64)).astype(np.float32)
    w = (0.1 * rng.standard_normal(64)).astype(np.float32)
    y_r, vjp = jax.vjp(lambda a, b: _rmsnorm_lowp(a, b, 1e-6),
                       jnp.asarray(x, jnp.bfloat16),
                       jnp.asarray(w, jnp.bfloat16))
    dx_r, dw_r = vjp(jnp.asarray(dy, jnp.bfloat16))
    xt = torch.tensor(x).bfloat16().requires_grad_()
    wt = torch.tensor(w).bfloat16().requires_grad_()
    y = RMSNormLowp.apply(xt, wt, 1e-6)
    dx, dw = torch.autograd.grad(y, (xt, wt), torch.tensor(dy).bfloat16())
    assert y.dtype == dx.dtype == dw.dtype == torch.bfloat16
    for got, want in ((y, y_r), (dx, dx_r), (dw, dw_r)):
        np.testing.assert_array_equal(got.detach().float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


def _grads_with_remat(remat):
    rp, cfg = _params("phi3.5-moe-42b-a6.6b")
    cfg = dataclasses.replace(cfg, remat=remat)
    tp = tree.tree_map(lambda p: p.requires_grad_(),
                       _port_params("phi3.5-moe-42b-a6.6b"))
    loss, _ = T.lm_loss(tp, _batch(cfg), cfg)
    return loss, torch.autograd.grad(loss, tree.leaves(tp))


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_changes_no_value(remat):
    """Each remat mode's loss and gradients equal ``"none"``'s bit for bit
    (the MoE model: the pattern's blocks carry aux through the repeat)."""
    loss_n, grads_n = _grads_with_remat("none")
    loss, grads = _grads_with_remat(remat)
    assert torch.equal(loss, loss_n)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads_n))


def test_remat_is_checked_and_skipped_without_autograd():
    _, cfg = _params("granite-3-2b")
    tp = _port_params("granite-3-2b")
    bad = dataclasses.replace(cfg, remat="most")
    with pytest.raises(ValueError, match="remat"):
        T.lm_loss(tree.tree_map(lambda p: p.requires_grad_(), tp),
                  _batch(cfg), bad)
    with torch.no_grad():       # serving never recomputes
        T.forward(tp, _batch(cfg)["inputs"], cfg=bad)


def test_aux_sums_the_last_block_of_each_repeat_as_the_reference():
    """A pattern of two MoE blocks: the reference's scan adds only the
    second block's aux of each repeat; prefix and suffix blocks add
    theirs.  The port computes the same sum."""
    rcfg = dataclasses.replace(ref_smoke("phi3.5-moe-42b-a6.6b"),
                               pattern=("global", "local"), repeats=2,
                               sliding_window=4, prefix=("global",),
                               suffix=("global",), moe_in_prefix=True)
    pcfg = dataclasses.replace(
        registry.get_smoke_config("phi3.5-moe-42b-a6.6b"),
        pattern=("global", "local"), repeats=2, sliding_window=4,
        prefix=("global",), suffix=("global",), moe_in_prefix=True)
    rp = ref_init(jax.random.PRNGKey(3), rcfg)
    toks = _batch(pcfg)["inputs"]
    _, _, want = jax.jit(lambda p: R.forward(p, jnp.asarray(toks),
                                             cfg=rcfg))(rp)
    _, _, got = T.forward(lm_params_from_numpy(_np(rp), "cpu"), toks,
                          cfg=pcfg)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# The train step, AdamW over trees
# ---------------------------------------------------------------------------

def _steps(arch, compute, grad_dtype="fp32"):
    """One reference step and one port step from the same params, AdamW
    state and batch."""
    rp, cfg = _params(arch)
    batch = _batch(cfg, seed=4)
    r_state = ref_opt.init_opt_state(rp)
    r_step = ref_steps.make_train_step(
        ref_smoke(arch), ref_opt.OptConfig(**OPT), compute_dtype=compute[0],
        grad_dtype=grad_dtype)
    rp2, rs2, rm = jax.jit(r_step)(rp, r_state, _jnp(batch))
    tp = _port_params(arch)
    state = opt_state_from_numpy(_np(r_state), "cpu")
    step = steps.make_train_step(cfg, optimizer.OptConfig(**OPT),
                                 compute_dtype=compute[1],
                                 grad_dtype=grad_dtype)
    tp2, s2, m = step(tp, state, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    return (rp2, rs2, rm), (tp2, s2, m), tp


@pytest.mark.parametrize("arch", ["granite-3-2b", "phi3.5-moe-42b-a6.6b"])
def test_train_step_matches_the_reference_step_in_fp32(arch):
    (rp2, rs2, rm), (tp2, s2, m), tp = _steps(
        arch, (jnp.float32, torch.float32))
    assert tp2 is tp                              # updated in place
    for k in ("loss", "ce", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(rm[k]), rtol=1e-5,
                                   atol=1e-9)
    _close_leaves(s2["m"], rs2["m"])
    _close_leaves(s2["v"], rs2["v"])
    assert int(s2["step"]) == int(rs2["step"]) == 1
    lr = float(rm["lr"])
    for got, want, m_r in zip(tree.leaves(tp2),
                              jax.tree_util.tree_leaves(rp2),
                              jax.tree_util.tree_leaves(rs2["m"])):
        want, m_r = np.asarray(want), np.abs(np.asarray(m_r))
        d = np.abs(got.numpy() - want)
        well = m_r >= 1e-4 * m_r.max()          # m = (1 - b1) g at step 1
        assert d.max() <= 2.1 * lr
        assert np.all(d[well] <= 1e-5 * lr + 2 * np.spacing(
            np.abs(want[well])))


@pytest.mark.parametrize("grad_dtype", ["fp32", "bf16"])
def test_train_step_in_bf16_is_near_the_reference_step(grad_dtype):
    (rp2, rs2, rm), (tp2, s2, m), _ = _steps(
        "granite-3-2b", (jnp.bfloat16, torch.bfloat16), grad_dtype)
    np.testing.assert_allclose(float(m["loss"]), float(rm["loss"]),
                               rtol=1e-2)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(rm["grad_norm"]), rtol=5e-2)
    assert all(p.dtype == torch.float32 for p in tree.leaves(tp2))


def test_train_step_refuses_kernels_and_sharding():
    """The kernels backend has no backward; a step given ``shd`` runs on
    ``backend="torch"`` only, and ``ShardingCtx(mesh=None)`` is the plain
    step, bit for bit."""
    _, cfg = _params("granite-3-2b")
    with pytest.raises(ValueError, match="backward"):
        steps.make_train_step(cfg, optimizer.OptConfig(), backend="kernels")
    with pytest.raises(ValueError, match="sharded"):
        steps.make_train_step(cfg, optimizer.OptConfig(), shd=ShardingCtx(),
                              backend="kernels")
    with pytest.raises(ValueError, match="sharded"):
        TrainLoop(cfg, optimizer.OptConfig(), data.DataConfig(kind="lm"),
                  LoopConfig(), shd=ShardingCtx(), device="cpu",
                  backend="kernels")
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg).items()}
    out = []
    for shd in (None, ShardingCtx()):
        p = _port_params("granite-3-2b")
        o = optimizer.init_opt_state(p)
        p, o, m = steps.make_train_step(
            cfg, optimizer.OptConfig(**OPT), shd,
            compute_dtype=torch.float32)(p, o, batch)
        out.append((p, o, m))
    (p0, o0, m0), (p1, o1, m1) = out
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    for a, b in zip(tree.leaves((p0, o0)), tree.leaves((p1, o1))):
        assert torch.equal(a, b)


def test_prefill_and_serve_steps_match_the_reference():
    rp, cfg = _params("phi3.5-moe-42b-a6.6b")
    rcfg = ref_smoke("phi3.5-moe-42b-a6.6b")
    toks = _batch(cfg, t=7)["inputs"]
    want, rcache = ref_steps.make_prefill_step(rcfg, 16)(rp, jnp.asarray(
        toks))
    tp = _port_params("phi3.5-moe-42b-a6.6b")
    got, cache = steps.make_prefill_step(cfg, 16)(tp, toks)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    tok = np.array([[3], [9]], np.int32)
    rn, rl, _ = ref_steps.make_serve_step(rcfg)(rp, rcache, jnp.asarray(tok),
                                                jnp.asarray(7, jnp.int32))
    n, lg, _ = steps.make_serve_step(cfg)(tp, cache, tok, 7)
    np.testing.assert_allclose(lg.numpy(), np.asarray(rl), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_array_equal(n.numpy(), np.asarray(rn))


def test_adamw_over_a_tree_with_lists_matches_reference():
    rng = np.random.default_rng(3)

    def draw():
        return {"a": rng.standard_normal((3, 4)).astype(np.float32),
                "prefix": [{"w": rng.standard_normal(5).astype(np.float32)},
                           {"w": rng.standard_normal(2).astype(np.float32)}],
                "blocks": {"s0": {"k": rng.standard_normal(
                    (2, 3)).astype(np.float32)}}, "suffix": []}

    p_np = draw()
    cfg = dict(peak_lr=1e-2, warmup_steps=2, decay_steps=5, clip_norm=0.5)
    p_r = jax.tree_util.tree_map(jnp.asarray, p_np)
    s_r = ref_opt.init_opt_state(p_r)
    params = lm_params_from_numpy(p_np, "cpu")
    state = optimizer.init_opt_state(params)
    assert [k for k, _ in tree.leaves_with_keys(state)] == [
        jax.tree_util.keystr(p) for p, _ in
        jax.tree_util.tree_flatten_with_path(s_r)[0]]
    for _ in range(3):
        g = draw()
        p_r, s_r, m_r = ref_opt.adamw_update(
            p_r, jax.tree_util.tree_map(jnp.asarray, g), s_r,
            ref_opt.OptConfig(**cfg))
        params, state, m = optimizer.adamw_update(
            params, lm_params_from_numpy(g, "cpu"), state,
            optimizer.OptConfig(**cfg))
        assert float(m["grad_norm"]) == pytest.approx(
            float(m_r["grad_norm"]), rel=1e-6)
        _close_leaves(params, p_r)
        _close_leaves(state["m"], s_r["m"])
        _close_leaves(state["v"], s_r["v"])


# ---------------------------------------------------------------------------
# Checkpoints of LM trees, the data stream
# ---------------------------------------------------------------------------

def test_lm_checkpoint_round_trips_keyed_as_the_reference(tmp_path):
    rp, cfg = _params("granite-3-2b")
    rcfg = dataclasses.replace(ref_smoke("granite-3-2b"),
                               prefix=("global",), repeats=2)
    pcfg = dataclasses.replace(cfg, prefix=("global",), repeats=2)
    rp = ref_init(jax.random.PRNGKey(1), rcfg)
    r_tree = {"params": rp, "opt": ref_opt.init_opt_state(rp)}
    tp = lm_params_from_numpy(_np(rp), "cpu")
    state = {"params": tp, "opt": optimizer.init_opt_state(tp)}
    assert state["params"]["suffix"] == [] and len(
        state["params"]["prefix"]) == 1
    ckpt.save(state, tmp_path, 5)
    manifest = json.loads((tmp_path / "step_00000005" / "manifest.json")
                          .read_text())
    want_keys = [jax.tree_util.keystr(p) for p, _ in
                 jax.tree_util.tree_flatten_with_path(r_tree)[0]]
    assert manifest["keys"] == want_keys
    assert "['params']['prefix'][0]['input_norm']" in want_keys
    template = {"params": T.init_model(torch.Generator().manual_seed(9),
                                       pcfg, device="cpu")}
    template["opt"] = optimizer.init_opt_state(template["params"])
    back, _ = ckpt.restore(template, tmp_path)
    assert back["params"]["suffix"] == []
    for got, want in zip(tree.leaves(back), tree.leaves(state)):
        assert torch.equal(got, want)
    # The reference restores the port's LM checkpoint, and the port its.
    ref_back, _ = ref_ckpt.restore(r_tree, tmp_path)
    np.testing.assert_array_equal(
        np.asarray(ref_back["params"]["prefix"][0]["q_proj"]),
        tp["prefix"][0]["q_proj"].numpy())
    ref_ckpt.save(r_tree, tmp_path / "ref", 2)
    back, _ = ckpt.restore(template, tmp_path / "ref")
    assert torch.equal(back["params"]["blocks"]["s0"]["k_proj"],
                       tp["blocks"]["s0"]["k_proj"])


def test_lm_batch_recurrence_determinism_and_skip():
    cfg = data.DataConfig(kind="lm", vocab_size=1000, seq_len=64,
                          global_batch=4, seed=3)
    b = data.lm_batch(cfg, 7)
    assert b["inputs"].shape == b["targets"].shape == (4, 64)
    np.testing.assert_array_equal(b["inputs"][:, 1:], b["targets"][:, :-1])
    seq = np.concatenate([b["inputs"], b["targets"][:, -1:]], axis=1)
    stride = (seq[:, 1:] - seq[:, :-1]) % 1000
    # Most steps follow x[t+1] = x[t] + a (mod V) with one odd a in 31..45
    # a row; ~5% of the tokens are noise.
    for row in stride:
        a = np.bincount(row).argmax()
        assert a % 2 == 1 and 31 <= a <= 45
        assert (row == a).mean() > 0.8
    np.testing.assert_array_equal(data.lm_batch(cfg, 7)["inputs"],
                                  b["inputs"])
    assert not np.array_equal(data.lm_batch(cfg, 8)["inputs"], b["inputs"])
    it = data.DataIterator(cfg)
    first = [next(it)["inputs"] for _ in range(3)]
    it.skip_to(7)
    np.testing.assert_array_equal(next(it)["inputs"], b["inputs"])
    np.testing.assert_array_equal(
        next(data.DataIterator(cfg, start_step=2))["inputs"], first[2])
    assert data.batch_for_step(cfg, 7)["inputs"].dtype == np.int64
    frames = data.batch_for_step(dataclasses.replace(
        cfg, kind="frames", frontend_dim=8), 0)
    assert frames["inputs"].shape == (4, 64, 8)
    # Existing call sites: DataConfig(global_batch=...) makes digits.
    assert data.batch_for_step(data.DataConfig(global_batch=2), 0)[
        "images"].shape == (2, 28, 28, 1)
    assert dataclasses.asdict(data.DataConfig(kind="lm")) == \
        dataclasses.asdict(ref_data.DataConfig(kind="lm"))


# ---------------------------------------------------------------------------
# The fault-tolerant loop (the counterparts of tests/test_training.py)
# ---------------------------------------------------------------------------

def _loop(tmp_path, total=8, ckpt_every=4):
    cfg = registry.get_smoke_config("granite-3-2b")
    dc = data.DataConfig(kind="lm", vocab_size=cfg.vocab_size, seq_len=16,
                         global_batch=4)
    lc = LoopConfig(total_steps=total, ckpt_every=ckpt_every,
                    ckpt_dir=str(tmp_path / "ck"), log_every=1000,
                    heartbeat_path=str(tmp_path / "hb.json"))
    return TrainLoop(cfg, optimizer.OptConfig(peak_lr=1e-3, warmup_steps=2),
                     dc, lc, device="cpu")


def test_loop_runs_and_checkpoints(tmp_path):
    loop = _loop(tmp_path)
    hist = loop.run()
    assert len(hist) == 8
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in hist)
    assert 8 in ckpt.committed_steps(tmp_path / "ck")
    assert json.loads((tmp_path / "hb.json").read_text())["step"] == 8


def test_loop_resume_gives_the_uninterrupted_losses(tmp_path):
    full = _loop(tmp_path / "x", total=8, ckpt_every=100).run()
    a = _loop(tmp_path / "y", total=4, ckpt_every=4)
    a.run()
    b = _loop(tmp_path / "y", total=8, ckpt_every=4)
    hist = b.run(resume=True)
    assert hist[0]["step"] == 5 and b.step == 8
    assert [h["loss"] for h in hist] == [h["loss"] for h in full[4:]]


def test_loop_preemption_then_resume(tmp_path):
    full = _loop(tmp_path / "x", total=7, ckpt_every=100).run()
    loop = _loop(tmp_path, total=7, ckpt_every=50)
    orig = loop._heartbeat

    def hb_and_stop(step, metrics):
        orig(step, metrics)
        if step >= 3:
            loop.request_stop()

    loop._heartbeat = hb_and_stop
    loop.run()
    assert loop.step == 3
    assert 3 in ckpt.committed_steps(tmp_path / "ck")   # the final save
    hist = _loop(tmp_path, total=7, ckpt_every=50).run(resume=True)
    assert [h["loss"] for h in hist] == [h["loss"] for h in full[3:]]


def test_loop_nan_guard_rolls_back_and_skips_the_batch(tmp_path):
    ckpt.save({"bogus": np.zeros((2, 2))}, tmp_path / "ck", 40)  # stale
    loop = _loop(tmp_path, total=6, ckpt_every=4)
    inner = loop._step_fn
    calls = {"n": 0}
    seen = []

    def poisoned(params, opt, batch):
        calls["n"] += 1
        seen.append(batch["inputs"][0, 0].item())
        params, opt, metrics = inner(params, opt, batch)
        if calls["n"] == 3:
            metrics = dict(metrics, loss=torch.tensor(float("nan")))
        return params, opt, metrics

    loop._step_fn = poisoned
    hist = loop.run(resume=False)
    assert loop.nan_skips == 1 and loop.step == 6
    assert 3 not in [h["step"] for h in hist]           # batch 2 skipped
    assert all(np.isfinite(h["loss"]) for h in hist)
    dc = loop.data_cfg
    assert seen == [data.lm_batch(dc, s)["inputs"][0, 0]
                    for s in (0, 1, 2, 3, 4, 5)]


def test_loop_straggler_hook(tmp_path):
    seen = []
    loop = _loop(tmp_path, total=7)
    loop.on_straggler = lambda step, t: seen.append(step)
    inner = loop._step_fn
    calls = {"n": 0}

    def slow(params, opt, batch):
        calls["n"] += 1
        out = inner(params, opt, batch)
        if calls["n"] == 7:       # 4x the slowest step so far
            import time
            time.sleep(4 * max(loop._times))
        return out

    loop._step_fn = slow
    loop.run()
    assert 6 in seen
