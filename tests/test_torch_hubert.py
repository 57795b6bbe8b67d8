"""The audio encoder (hubert-xlarge: the frame frontend, bidirectional
blocks) through the port against the reference, on the CPU: the smoke
model's logits on both backends, a position that sees the future,
``lm_loss`` on a ``frames_batch`` (with and without a frame mask) against
``jax.grad``, the encoder's prefill step, a ``TrainLoop`` on the frames
stream, the engine's refusal, and K15 at hubert's head dim 80: its twin
against the reference kernel (interpret mode), its prefill tile and the
decode plan's refusal.

Parameters come from the reference's ``init_model`` through
``convert.lm_params_from_numpy``; frames are seeded numpy arrays fed to
both sides.  Logits are held at rtol/atol 2e-5 (the reference's kernel
tolerance), gradients at 1e-5 of each leaf's largest value.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke
from repro.kernels import ops as rops
from repro.models import init_model as ref_init
from repro.models import transformer as R
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core.execplan import PlanError
from repro_torch.kernels import flash_attention as k15
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServeEngine
from repro_torch.train import optimizer
from repro_torch.train.data import DataConfig, frames_batch
from repro_torch.train.loop import LoopConfig, TrainLoop

ARCH = "hubert-xlarge"
TOL = dict(rtol=2e-5, atol=2e-5)
GRAD = 1e-5


@functools.lru_cache(maxsize=None)
def _model():
    """(reference params, the port's copy on the CPU, port config)."""
    rp = ref_init(jax.random.PRNGKey(0), ref_smoke(ARCH))
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, rp), "cpu")
    return rp, tp, registry.get_smoke_config(ARCH)


def _frames(cfg, b, t, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, t, cfg.frontend_dim)).astype(np.float32)


@pytest.mark.parametrize("backend", ["torch", "kernels"])
def test_hubert_smoke_forward_matches_reference(backend):
    rp, tp, cfg = _model()
    frames = _frames(cfg, 2, 13)
    want, _, _ = R.forward(rp, jnp.asarray(frames), cfg=ref_smoke(ARCH))
    got, cache, aux = T.forward(tp, frames, cfg=cfg, backend=backend)
    assert cache is None and float(aux) == 0.0
    assert "frontend_proj" in tp
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_bidirectional_position_sees_the_future():
    """Changing only the last frame moves position 0's logits (the
    reference's ``test_encoder_bidirectional_sees_future``)."""
    _, tp, cfg = _model()
    frames = _frames(cfg, 1, 8, seed=1)
    later = frames.copy()
    later[:, -1] = 0.0
    a = T.forward(tp, frames, cfg=cfg, backend="kernels")[0]
    b = T.forward(tp, later, cfg=cfg, backend="kernels")[0]
    assert not torch.allclose(a[:, 0], b[:, 0])
    torch.testing.assert_close(a, T.forward(tp, frames, cfg=cfg)[0], **TOL)


@pytest.mark.parametrize("mask", [False, True])
def test_hubert_lm_loss_on_frames_matches_jax_grad(mask):
    """``lm_loss`` on the frames stream's batch (float frames, cluster-id
    targets; with ``mask``, only a masked span's frames count, as in
    masked-frame prediction) and its gradient in every leaf, the frontend
    projection included, against ``jax.grad`` (``embed``, which an untied
    encoder never reads, gets 0 in both)."""
    rp, tp, cfg = _model()
    batch = frames_batch(DataConfig(kind="frames", vocab_size=cfg.vocab_size,
                                    seq_len=12, global_batch=2,
                                    frontend_dim=cfg.frontend_dim), 0)
    if mask:
        m = np.zeros((2, 12), np.float32)
        m[:, 3:8] = 1.0
        batch["mask"] = m
        batch["inputs"] = np.where(m[..., None] > 0, 0.0,
                                   batch["inputs"]).astype(np.float32)
    (want, _), want_g = jax.value_and_grad(
        lambda p: R.lm_loss(p, {k: jnp.asarray(v) for k, v in batch.items()},
                            ref_smoke(ARCH)), has_aux=True)(rp)
    wrt = tree.tree_map(lambda p: p.detach().requires_grad_(), tp)
    loss, _ = T.lm_loss(wrt, batch, cfg)
    grads = steps.leaf_grads(loss, tree.leaves(wrt))
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-6)
    want_leaves = jax.tree_util.tree_leaves(want_g)
    assert len(grads) == len(want_leaves)
    for g, w in zip(grads, want_leaves):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        assert np.abs(g.numpy() - w).max() <= GRAD * max(np.abs(w).max(),
                                                         1e-30)


def test_encoder_has_no_decode_path():
    """``ServeEngine`` refuses an encoder-only config, as the reference's
    does; the prefill step returns every position's logits and no cache."""
    rp, tp, cfg = _model()
    with pytest.raises(ValueError, match="encoder-only"):
        ServeEngine(tp, cfg, device="cpu")
    assert T.init_model_cache(cfg, 1, 8, device="cpu")["blocks"]["s0"] is None
    frames = _frames(cfg, 1, 9, seed=2)
    logits, cache = steps.make_prefill_step(cfg, 16)(tp, frames)
    assert cache is None
    want, _, _ = R.forward(rp, jnp.asarray(frames), cfg=ref_smoke(ARCH))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **TOL)


def test_train_loop_takes_the_frames_stream(tmp_path):
    """``TrainLoop`` on ``DataConfig(kind="frames")``: float32 [B, T, F]
    inputs and int targets, bf16 compute over fp32 masters (the frames
    cast to the compute type), finite losses and gradient norms."""
    cfg = registry.get_smoke_config(ARCH)
    data = DataConfig(kind="frames", vocab_size=cfg.vocab_size, seq_len=16,
                      global_batch=4, frontend_dim=cfg.frontend_dim)
    loop = TrainLoop(cfg, optimizer.OptConfig(peak_lr=1e-3, warmup_steps=1,
                                              decay_steps=10), data,
                     LoopConfig(total_steps=3, ckpt_every=10,
                                ckpt_dir=str(tmp_path), log_every=100),
                     device="cpu")
    hist = loop.run(resume=False)
    assert len(hist) == 3
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               for h in hist)


def test_k15_at_head_dim_80():
    """Hubert's 16 heads of 80: K15's twin against the reference kernel
    (interpret mode), bidirectional and causal; its prefill tile (32 keys:
    two CTAs an SM); the decode plan refuses D 80 by name and a one-row
    call takes the prefill schedule."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((1, 4, 96, 80)).astype(np.float32)
               for _ in range(3))
    for causal in (False, True):
        want = rops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal)
        got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                  causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert 80 in k15.HEAD_DIMS and 80 not in k15.DECODE_HEAD_DIMS
    assert k15.plan_tiles(80) == (64, 32)
    assert k15.smem_bytes(80, 32) == 73_728
    assert k15.resident_ctas(80, 32) == 2 and k15.resident_ctas(80, 64) == 1
    with pytest.raises(PlanError, match="head_dim 80"):
        k15.plan_decode(8, 16, 1, 512, 80)
    assert k15.plan_decode(8, 16, 1024, 1024, 80) is None   # a prefill
    q1 = torch.zeros(2, 1, 16, 80)
    kv = torch.zeros(2, 64, 16, 80)
    assert k15.schedule(q1, kv) == k15.Schedule("prefill", block_k=32)
    with pytest.raises(PlanError, match="head_dim 80"):
        k15.schedule(q1, kv, splits=2)
