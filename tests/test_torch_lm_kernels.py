"""The port's LM kernels, K16 RMSNorm and K15 flash attention, against the
reference.

Inputs are made with numpy from a seed and go through both: the
reference's ``repro.kernels.ops`` in interpret mode (as
tests/test_kernels.py runs them) or its model's ``grouped_attention``,
and the port's wrappers on CPU tensors, which run the plain PyTorch
twins.  Tolerances are the reference's own (tests/test_kernels.py): 2e-5
in fp32, 2e-2 in bf16.  The CUDA kernels themselves are held against the
same twins on the card by tests/test_torch_gpu.py and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro.models.attention import _cache_positions, grouped_attention
from repro.models.attention import query_positions
from repro_torch.core import faults
from repro_torch.core.execplan import PlanError
from repro_torch.core.planner import NUM_SMS, SMEM_BYTES
from repro_torch.kernels import flash_attention as k15
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rmsnorm as k16

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _rand(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# K16 rmsnorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,d", [(8, 64), (1024, 512), (7, 384), (1, 3584),
                                    (4, 3584), (8, 3584)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_matches_reference(rows, d, dtype):
    x, w = _rand(rows, rows, d), _rand(d, d, scale=0.1)
    want = rops.rmsnorm(jnp.asarray(x, JDT[dtype]), jnp.asarray(w))
    xt = torch.from_numpy(x).to(TDT[dtype])
    got = ops.rmsnorm(xt, torch.from_numpy(w))
    assert got.dtype == TDT[dtype]
    for out in (got, ref.rmsnorm(xt, torch.from_numpy(w))):
        np.testing.assert_allclose(_f32(out), _f32(want), rtol=TOL[dtype],
                                   atol=TOL[dtype])


def test_rmsnorm_keeps_leading_dims_and_refuses_a_wrong_weight():
    x = torch.from_numpy(_rand(0, 2, 3, 16))
    assert ops.rmsnorm(x, torch.zeros(16)).shape == (2, 3, 16)
    with pytest.raises(ValueError, match="weight"):
        ops.rmsnorm(x, torch.zeros(8))


# ---------------------------------------------------------------------------
# K15 flash attention: the reference kernel's own cases
# ---------------------------------------------------------------------------

def _qkv(seed, b, h, tq, tk, d, kvh=None):
    kvh = h if kvh is None else kvh
    return (_rand(seed, b, h, tq, d), _rand(seed + 1, b, kvh, tk, d),
            _rand(seed + 2, b, kvh, tk, d))


def _both(q, k, v, **kw):
    want = rops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), **kw)
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("tq,tk,win,cap,causal", [
    (128, 128, None, None, True),
    (256, 256, 64, None, True),
    (128, 128, None, 50.0, True),
    (1, 256, None, None, True),          # decode
    (8, 264, 32, 30.0, True),            # non-pow2 kv + window + softcap
    (64, 64, None, None, False),         # bidirectional
    (96, 96, 16, None, True),
])
def test_flash_attention_matches_reference(tq, tk, win, cap, causal):
    q, k, v = _qkv(tq + tk, 2, 4, tq, tk, 64)
    got, want = _both(q, k, v, causal=causal, window=win, softcap=cap)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    oracle = ref.attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                           window=win, softcap=cap)
    np.testing.assert_allclose(oracle.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_attention_head_dims(d):
    got, want = _both(*_qkv(d, 1, 2, 128, 128, d), causal=True)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_flash_attention_rows_without_a_key_give_the_mean_of_v():
    """Tq > Tk under causal: the first Tq - Tk rows see no key.  With
    masked logits at -1e30 (not -inf) every key weighs alike: the
    reference kernel, its oracle and the port all return mean(V)."""
    q, k, v = _qkv(5, 1, 1, 8, 4, 16)
    got, want = _both(q, k, v, causal=True)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    mean_v = v.mean(axis=2, keepdims=True)
    np.testing.assert_allclose(got[:, :, :4], np.broadcast_to(
        mean_v, (1, 1, 4, 16)), rtol=2e-5, atol=2e-5)
    from repro.kernels import ref as rref
    np.testing.assert_allclose(np.asarray(rref.attention(
        *map(jnp.asarray, (q, k, v)), causal=True)), got, rtol=2e-5,
        atol=2e-5)


# ---------------------------------------------------------------------------
# K15's extensions against the model's grouped_attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,kvh,win,cap", [(4, 2, None, None),
                                          (8, 2, 5, 50.0),
                                          (4, 1, None, 30.0),
                                          (4, 4, 3, None)])
def test_flash_gqa_by_index_matches_grouped_attention(h, kvh, win, cap):
    b, t, d = 2, 19, 16
    q, k, v = (_rand(1, b, t, h, d), _rand(2, b, t, kvh, d),
               _rand(3, b, t, kvh, d))
    pos = jnp.broadcast_to(jnp.arange(t)[None], (b, t))
    want = grouped_attention(*map(jnp.asarray, (q, k, v)), pos, pos,
                             causal=True, window=win, softcap=cap,
                             scale=0.3)
    got = k15.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=True, window=win, softcap=cap,
                              scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("win", [None, 4])
def test_flash_kv_len_matches_grouped_attention_under_cache_positions(t,
                                                                      win):
    """Per-row key counts (the engine's slots at different lengths): row b
    holds ``ci[b] + t`` keys of an S-long cache whose tail is stale."""
    b, s, h, kvh, d = 3, 24, 4, 2, 16
    ci = np.array([0, 7, 20], np.int32)
    q = _rand(11, b, t, h, d)
    k, v = _rand(12, b, s, kvh, d), _rand(13, b, s, kvh, d)
    q_pos = query_positions(jnp.asarray(ci), b, t)
    kv_pos = _cache_positions(jnp.asarray(ci), b, s, t)
    want = grouped_attention(*map(jnp.asarray, (q, k, v)), q_pos, kv_pos,
                             causal=True, window=win, softcap=50.0,
                             scale=0.25)
    got = k15.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              kv_len=torch.from_numpy(ci + t), causal=True,
                              window=win, softcap=50.0, scale=0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("win", [None, 4])
def test_flash_kv_len_past_tk_is_clamped_to_tk(win):
    """A key count past the cache's end reads no key beyond it: the row
    sees all Tk keys, as ``grouped_attention`` does over a full cache."""
    b, t, s, h, kvh, d = 2, 3, 16, 4, 2, 16
    q = _rand(21, b, t, h, d)
    k, v = _rand(22, b, s, kvh, d), _rand(23, b, s, kvh, d)
    lens = np.array([s + 40, 9], np.int32)
    ci = np.minimum(lens, s) - t
    want = grouped_attention(
        *map(jnp.asarray, (q, k, v)), query_positions(jnp.asarray(ci), b, t),
        _cache_positions(jnp.asarray(ci), b, s, t), causal=True, window=win,
        softcap=50.0, scale=0.25)
    got = k15.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              kv_len=torch.from_numpy(lens), causal=True,
                              window=win, softcap=50.0, scale=0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_rows_of_no_keys_give_zero(causal):
    """``kv_len <= 0`` leaves a row no key to weigh: it returns 0 (not
    the NaN of a softmax over nothing), and the other rows are unmoved."""
    q = torch.from_numpy(_rand(31, 3, 2, 4, 16))
    k = torch.from_numpy(_rand(32, 3, 7, 2, 16))
    v = torch.from_numpy(_rand(33, 3, 7, 2, 16))
    got = k15.flash_attention(q, k, v, kv_len=torch.tensor(
        [0, -3, 5], dtype=torch.int32), causal=causal)
    assert torch.equal(got[:2], torch.zeros_like(got[:2]))
    want = k15.flash_attention(q[2:], k[2:], v[2:], kv_len=torch.tensor(
        [5], dtype=torch.int32), causal=causal)
    torch.testing.assert_close(got[2:], want, rtol=0, atol=0)


def test_flash_reads_a_bf16_cache_as_its_values():
    q = torch.from_numpy(_rand(1, 2, 5, 4, 16))
    k = torch.from_numpy(_rand(2, 2, 9, 2, 16)).bfloat16()
    v = torch.from_numpy(_rand(3, 2, 9, 2, 16)).bfloat16()
    lens = torch.tensor([5, 9], dtype=torch.int32)
    got = k15.flash_attention(q, k, v, kv_len=lens, softcap=50.0)
    want = k15.flash_attention(q, k.float(), v.float(), kv_len=lens,
                               softcap=50.0)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_flash_writes_into_a_strided_out():
    q, k, v = (torch.from_numpy(a) for a in _qkv(3, 2, 4, 6, 6, 16))
    out = torch.empty(2, 6, 4, 16).transpose(1, 2)
    res = ops.flash_attention(q, k, v)
    k15.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), out=out.transpose(1, 2))
    torch.testing.assert_close(out, res, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["kv_len", "window", "heads", "out"])
def test_flash_refuses_bad_arguments(bad):
    q = torch.zeros(2, 3, 4, 16)
    k = torch.zeros(2, 5, 2, 16)
    kw = {"kv_len": dict(kv_len=torch.ones(2, dtype=torch.int64)),
          "window": dict(window=0),
          "heads": dict(),
          "out": dict(out=torch.zeros(2, 3, 4, 8))}[bad]
    if bad == "heads":
        k = torch.zeros(2, 5, 3, 16)
    with pytest.raises(ValueError):
        k15.flash_attention(q, k, k, **kw)


# ---------------------------------------------------------------------------
# Tiles, gradients and fault sites
# ---------------------------------------------------------------------------

def test_plan_tiles_follow_the_shared_memory_budget():
    """The tile an SM holds most CTAs of, then the widest: at D = 256 only
    the 32-key tile fits (208,896 B); at D = 128 the 32-key tile lets two
    CTAs share an SM (110,592 B) where the 64-key one (185,856 B) allows
    one; 64 keys below.  A smaller budget halves the tile, a too small one
    is refused by name."""
    want = {16: 64, 32: 64, 64: 64, 128: 32, 256: 32}
    for d in k15.HEAD_DIMS:
        bq, bk = k15.plan_tiles(d)
        assert (bq, bk) == (64, want[d])
        assert k15.smem_bytes(d, bk) <= SMEM_BYTES
    assert k15.smem_bytes(256, 32) == 208_896
    assert k15.smem_bytes(256, 64) > SMEM_BYTES
    assert k15.smem_bytes(256, 64, kv_bytes=2) <= SMEM_BYTES  # a bf16 cache
    assert k15.resident_ctas(256, 32) == 1
    assert k15.resident_ctas(128, 64) == 1 and k15.resident_ctas(128, 32) == 2
    assert k15.resident_ctas(64, 64) == k15.resident_ctas(64, 32) == 2
    assert k15.plan_tiles(64, 100_000) == (64, 32)
    with pytest.raises(PlanError, match="head_dim 256"):
        k15.plan_tiles(256, 200_000)
    with pytest.raises(PlanError, match="head_dim 48"):
        k15.plan_tiles(48)


# ---------------------------------------------------------------------------
# K15's decode schedule: split-KV partials merged in split order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tq,group,splits,win,cap", [
    (1, 1, 1, None, None),
    (1, 2, 3, None, 30.0),
    (1, 4, 8, 5, None),                  # splits before the window: empty
    (3, 2, 8, 6, 50.0),                  # splits of row 2's masked keys
    (3, 4, 3, None, None),
    (3, 1, 8, None, 50.0),
])
def test_flash_decode_plain_matches_reference_kernel(tq, group, splits, win,
                                                     cap):
    """The decode twin against the reference's kernel (interpret mode,
    KV heads expanded as it expects) and the direct twin."""
    b, kvh, tk, d = 2, 2, 40, 16
    h = kvh * group
    q = _rand(tq + splits, b, h, tq, d)
    k, v = _rand(7, b, kvh, tk, d), _rand(8, b, kvh, tk, d)
    kw = dict(causal=True, window=win, softcap=cap)
    want = np.asarray(rops.flash_attention(
        jnp.asarray(q), jnp.asarray(np.repeat(k, group, axis=1)),
        jnp.asarray(np.repeat(v, group, axis=1)), **kw))
    qt, kt, vt = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    got = k15.flash_decode_plain(qt, kt, vt, splits=splits, **kw)
    direct = k15.flash_attention_plain(qt, kt, vt, **kw)
    for out in (got, direct):
        np.testing.assert_allclose(out.transpose(1, 2).numpy(), want,
                                   rtol=2e-5, atol=2e-5)


def test_flash_decode_plain_gives_the_mean_of_v_without_a_key():
    """Tq = 3 over 2 keys under causal: row 0 sees no key and every split
    holds only masked keys or none; the reference kernel returns mean(V)."""
    q, k, v = _qkv(41, 1, 2, 3, 2, 16)
    want = np.asarray(rops.flash_attention(*map(jnp.asarray, (q, k, v)),
                                           causal=True))
    qt, kt, vt = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    for splits in (1, 2, 8):
        got = k15.flash_decode_plain(qt, kt, vt, splits=splits)
        np.testing.assert_allclose(got.transpose(1, 2).numpy(), want,
                                   rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(want[:, :, 0], v.mean(axis=2), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("t", [1, 3])
@pytest.mark.parametrize("group,splits", [(1, 8), (2, 3), (4, 1)])
@pytest.mark.parametrize("win", [None, 4])
def test_flash_decode_plain_matches_grouped_attention_under_kv_len(
        t, group, splits, win):
    """Ragged rows, a row past Tk and a row of no keys: the decode twin
    against the reference model's ``grouped_attention`` over the cache
    (rows with keys), 0 for the empty row, and the direct twin."""
    b, s, kvh, d = 4, 24, 2, 16
    h = kvh * group
    lens = np.array([t + 7, s + 30, 0, s], np.int32)
    q = _rand(51, b, t, h, d)
    k, v = _rand(52, b, s, kvh, d), _rand(53, b, s, kvh, d)
    kw = dict(causal=True, window=win, softcap=50.0, scale=0.25)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    got = k15.flash_decode_plain(qt, kt, vt, splits=splits,
                                 kv_len=torch.from_numpy(lens), **kw)
    direct = k15.flash_attention_plain(qt, kt, vt,
                                       kv_len=torch.from_numpy(lens), **kw)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=2e-5,
                               atol=2e-5)
    assert torch.equal(got[2], torch.zeros_like(got[2]))
    keep = np.array([0, 1, 3])
    ci = np.minimum(lens[keep], s) - t
    want = grouped_attention(
        *map(jnp.asarray, (q[keep], k[keep], v[keep])),
        query_positions(jnp.asarray(ci), 3, t),
        _cache_positions(jnp.asarray(ci), 3, s, t), **kw)
    np.testing.assert_allclose(got.numpy()[keep], np.asarray(want),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b,kvh,tk", [(4, 8, 512), (4, 8, 4608),
                                      (1, 8, 4608), (1, 1, 300),
                                      (8, 8, 2048), (2, 2, 64)])
def test_plan_decode_fills_the_card_and_leaves_no_split_empty(b, kvh, tk):
    """At least one wave of CTAs where Tk allows, no split shorter than
    ``DECODE_MIN_KEYS`` (unless there is one), none empty when every row
    holds Tk keys; None above the decode row cap."""
    splits = k15.plan_decode(b, kvh, 2, tk, 256)
    n, chunk = k15.split_keys(tk, splits)
    assert n == splits and (splits - 1) * chunk < tk <= splits * chunk
    assert splits == 1 or chunk >= k15.DECODE_MIN_KEYS
    allows = tk >= k15.DECODE_MIN_KEYS * -(-NUM_SMS // (b * kvh))
    if allows:
        assert b * kvh * splits >= NUM_SMS
    assert k15.plan_decode(b, kvh, 9, tk, 256) is None
    assert k15.plan_decode(b, kvh, 16, tk, 128) is not None
    assert k15.plan_decode(b, kvh, 17, tk, 128) is None


def test_the_schedule_is_planned_from_shapes_not_kv_len(monkeypatch):
    """On the card the wrapper picks the schedule, the splits and the
    workspace from the shapes alone: two calls whose ``kv_len`` values
    differ launch the same decode arguments, and prefill-sized calls
    launch the prefill tile.  (The launch is recorded, not run.)"""
    calls = []
    monkeypatch.setattr(k15, "on_cpu", lambda *a, **kw: False)
    monkeypatch.setattr(k15, "stream_of", lambda t: None)
    monkeypatch.setattr(k15, "FLASH", lambda *a: calls.append(a))
    k = torch.zeros(4, 512, 8, 256)
    q = torch.zeros(4, 1, 16, 256)
    for lens in ([25, 308, 0, 512], [512, 1, 2, 3]):
        k15.flash_attention(q, k, k, kv_len=torch.tensor(lens,
                                                         dtype=torch.int32))
    assert calls[0][-5:-2] == calls[1][-5:-2] == (0, 8, 64)
    k15.flash_attention(torch.zeros(1, 300, 16, 256), k[:1], k[:1])
    assert calls[2][-5:-2] == (32, 0, 0) and calls[2][-2] is None
    with pytest.raises(ValueError, match="block_k 64"):
        k15.flash_attention(torch.zeros(1, 300, 16, 256), k[:1], k[:1],
                            block_k=64)
    with pytest.raises(ValueError, match="two schedules"):
        k15.flash_attention(q, k, k, block_k=32, splits=2)
    with pytest.raises(ValueError, match="decode schedule"):
        k15.flash_attention(torch.zeros(1, 9, 2, 256), k[:1, :, :2],
                            k[:1, :, :2], splits=2)


@pytest.mark.parametrize("q_shape,kv_shape,over,want", [
    ((4, 1, 16, 256), (4, 512, 8, 256), {}, ("decode", 8, 64, 0)),
    ((4, 1, 16, 256), (4, 4608, 8, 256), {}, ("decode", 9, 512, 0)),
    ((1, 300, 16, 256), (1, 512, 8, 256), {}, ("prefill", 0, 0, 32)),
    ((1, 300, 32, 64), (1, 300, 8, 64), {}, ("prefill", 0, 0, 64)),
    ((4, 1, 16, 256), (4, 512, 8, 256), dict(splits=3), ("decode", 3, 171,
                                                          0)),
    ((4, 1, 16, 256), (4, 512, 8, 256), dict(block_k=32), ("prefill", 0, 0,
                                                           32)),
])
def test_schedule_is_what_the_wrapper_launches(q_shape, kv_shape, over,
                                               want, monkeypatch):
    """``schedule`` names the schedule, splits and tile that the wrapper
    hands the kernel (the launch is recorded, not run), with and without
    the sweeps' overrides."""
    calls = []
    monkeypatch.setattr(k15, "on_cpu", lambda *a, **kw: False)
    monkeypatch.setattr(k15, "stream_of", lambda t: None)
    monkeypatch.setattr(k15, "FLASH", lambda *a: calls.append(a))
    q, k = torch.zeros(q_shape), torch.zeros(kv_shape)
    sched = k15.schedule(q, k, **over)
    assert tuple(sched) == want
    k15.flash_attention(q, k, k, **over)
    assert calls[0][-5:-2] == (sched.block_k, sched.splits, sched.chunk)
    assert str(sched).startswith(sched.kind)


@pytest.mark.parametrize("which", ["rmsnorm", "flash_attention"])
def test_wrappers_refuse_inputs_that_require_grad_on_the_card(which,
                                                              monkeypatch):
    """A launch would cut the autograd graph without a word: the CUDA
    path raises before it launches (the CPU twin stays differentiable)."""
    mod = k16 if which == "rmsnorm" else k15
    monkeypatch.setattr(mod, "on_cpu", lambda *a, **kw: False)
    x = torch.zeros(1, 4, 2, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        if which == "rmsnorm":
            k16.rmsnorm(x, torch.zeros(16))
        else:
            k15.flash_attention(x, x, x)


def test_twins_are_differentiable_on_the_cpu():
    x = torch.from_numpy(_rand(0, 1, 5, 2, 16)).requires_grad_()
    k15.flash_attention(x, x, x).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
    y = torch.from_numpy(_rand(1, 3, 16)).requires_grad_()
    k16.rmsnorm(y, torch.zeros(16)).sum().backward()
    assert y.grad is not None


@pytest.mark.parametrize("site", [faults.SITE_RMSNORM,
                                  faults.SITE_FLASH_ATTENTION])
def test_fault_sites_fire(site):
    q = torch.from_numpy(_rand(0, 1, 2, 4, 16))
    call = ((lambda: ops.rmsnorm(q, torch.zeros(16)))
            if site == faults.SITE_RMSNORM
            else (lambda: ops.flash_attention(q, q, q)))
    assert torch.isfinite(call()).all()
    with faults.inject(faults.FaultSpec(site=site, kind="nan_output")):
        assert torch.isnan(call()).all()
        assert torch.isfinite(call()).all()       # fired once
    with faults.inject(faults.FaultSpec(site=site, kind="plan_error")):
        with pytest.raises(PlanError, match=site):
            call()
