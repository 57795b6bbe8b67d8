"""The port's op counters (``launch/hlo_analysis.py``) against the
reference's HLO analyzer, on the CPU: ``tests/test_hlo_analysis.py``'s
cases on the port, then the same seeded inputs through both packages.

  * the forward ``lm_loss``'s flops and dot count equal ``analyze_hlo``'s
    on the compiled HLO exactly, on every LM arch's smoke config;
  * the fp32 train step's flops equal the reference's exactly for
    granite at remat ``none`` and ``full``;
  * zamba2's fp32 train step: the port counts 409,600 flops fewer, and
    the gap is pinned to the two Mamba ops that make it (below);
  * the byte model (views 0, a slice write twice the slice), the
    ``uncounted`` list and ``FlopCounterMode``'s total on the same call.

The counters that need a process group (DTensor's local ops, the
collectives) run in a child process: ``tests/test_torch_dryrun.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import LM_ARCHS as REF_ARCHS
from repro.configs import get_smoke_config as ref_smoke
from repro.launch import hlo_analysis as ha
from repro.launch import steps as ref_steps
from repro.models import init_model as ref_init
from repro.models import lm_loss as ref_lm_loss
from repro.train import optimizer as ref_opt
from repro_torch.configs import registry
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import steps
from repro_torch.launch.hlo_analysis import analyze_ops
from repro_torch.models import count_params
from repro_torch.models.transformer import lm_loss
from repro_torch.train import optimizer

BATCH, SEQ = 2, 32


def _analyze(fn, *args):
    return analyze_ops(fn, *args)[1]


# ---------------------------------------------------------------------------
# tests/test_hlo_analysis.py's cases
# ---------------------------------------------------------------------------

def test_plain_matmul_flops():
    a, b = torch.zeros(64, 128), torch.zeros(128, 32)
    out = _analyze(lambda x, y: x @ y, a, b)
    assert out.flops == 2 * 64 * 128 * 32
    assert out.dot_count == 1


def test_loop_multiplies_flops_by_trip_count():
    a = torch.zeros(32, 32)

    def fn(x):
        for _ in range(7):
            x = x @ x
        return x

    assert _analyze(fn, a).flops == 7 * 2 * 32 ** 3


def test_nested_loops_compose():
    a = torch.zeros(16, 16)

    def fn(x):
        for _ in range(5):
            for _ in range(3):
                x = x @ x
        return x

    assert _analyze(fn, a).flops == 15 * 2 * 16 ** 3


def test_batched_dot_flops():
    a, b = torch.zeros(4, 8, 16), torch.zeros(4, 16, 8)
    out = _analyze(lambda x, y: torch.einsum("bij,bjk->bik", x, y), a, b)
    assert out.flops == 2 * 4 * 8 * 16 * 8
    assert out.dot_count == 1


def test_memory_counts_argument_traffic():
    # One op: reads 4 MiB and writes 4 MiB, exactly (the per-op model).
    out = _analyze(lambda x: x + 1.0, torch.zeros(1024, 1024))
    assert out.memory_bytes == 2 * 4 * 2**20


def test_views_move_no_bytes_and_a_slice_write_counts_twice_the_slice():
    x = torch.zeros(64, 32)
    views = _analyze(lambda t: (t.view(32, 64), t.t(), t[:8],
                              t[:, None].expand(64, 4, 32), t.detach(),
                              t.as_strided((8, 8), (1, 8))), x)
    assert views.memory_bytes == 0 and views.flops == 0
    cache = torch.zeros(4, 128, 16)
    upd = torch.ones(4, 8, 16)
    w = _analyze(lambda c, u: c[:, 40:48].copy_(u), cache, upd)
    assert w.memory_bytes == 2 * upd.numel() * 4
    idx = (torch.arange(4)[:, None], torch.arange(8)[None, :] + 40)
    w2 = _analyze(lambda c, u: c.index_put_(idx, u), cache, upd)
    assert w2.memory_bytes == 2 * upd.numel() * 4


def test_real_smoke_model_flops_sane():
    """A smoke transformer's counted flops within 0.5-3x of analytic."""
    cfg = registry.get_smoke_config("granite-3-2b")
    params = _port_params("granite-3-2b")
    batch = {k: torch.zeros(BATCH, SEQ, dtype=torch.int64)
             for k in ("inputs", "targets")}
    with torch.no_grad():
        out = _analyze(lambda: lm_loss(params, batch, cfg)[0])
    tokens = BATCH * SEQ
    n_mat = count_params(cfg) - cfg.padded_vocab_size * cfg.d_model
    analytic = 2 * (n_mat * tokens
                    + cfg.padded_vocab_size * cfg.d_model * tokens)
    assert 0.5 * analytic < out.flops < 3.0 * analytic


# ---------------------------------------------------------------------------
# The port's counts against the reference's analyze_hlo
# ---------------------------------------------------------------------------

def _ref_params(arch, remat=None):
    cfg = ref_smoke(arch)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    return cfg, ref_init(jax.random.PRNGKey(0), cfg)


def _port_params(arch):
    _, rp = _ref_params(arch)
    return lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, rp),
                                "cpu")


def _batches(cfg):
    rng = np.random.default_rng(31)
    if cfg.frontend == "audio_frames":
        inputs = rng.standard_normal(
            (BATCH, SEQ, cfg.frontend_dim)).astype(np.float32)
    else:
        inputs = rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(
            np.int32)
    targets = rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    ref = {"inputs": jnp.asarray(inputs), "targets": jnp.asarray(targets)}
    port = {"inputs": torch.from_numpy(inputs),
            "targets": torch.from_numpy(targets.astype(np.int64))}
    return ref, port


def test_every_reference_arch_is_compared():
    assert sorted(registry.LM_ARCHS) == sorted(REF_ARCHS)


@pytest.mark.parametrize("arch", REF_ARCHS)
def test_forward_flops_equal_the_reference(arch):
    rcfg, rp = _ref_params(arch)
    cfg = registry.get_smoke_config(arch)
    rb, pb = _batches(cfg)
    text = jax.jit(lambda p, b: ref_lm_loss(p, b, rcfg)[0]).lower(
        rp, rb).compile().as_text()
    ref = ha.analyze_hlo(text)
    params = _port_params(arch)
    with torch.no_grad():
        got = _analyze(lambda: lm_loss(params, pb, cfg)[0])
    assert got.flops == ref.flops
    assert got.dot_count == ref.dot_count
    assert got.uncounted == {}


def _step_flops(arch, remat):
    rcfg, rp = _ref_params(arch, remat)
    cfg = dataclasses.replace(registry.get_smoke_config(arch), remat=remat)
    rb, pb = _batches(cfg)
    r_step = ref_steps.make_train_step(rcfg, ref_opt.OptConfig(),
                                       compute_dtype=jnp.float32)
    text = jax.jit(r_step).lower(rp, ref_opt.init_opt_state(rp),
                                 rb).compile().as_text()
    params = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, rp),
                                  "cpu")
    step = steps.make_train_step(cfg, optimizer.OptConfig(),
                                 compute_dtype=torch.float32)
    got = _analyze(step, params, optimizer.init_opt_state(params), pb)
    return cfg, ha.analyze_hlo(text).flops, got.flops


@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_step_flops_equal_the_reference(remat):
    _, ref, got = _step_flops("granite-3-2b", remat)
    assert got == ref


@pytest.mark.parametrize("remat", ["none", "full"])
def test_zamba2_train_step_gap_is_two_mamba_ops(remat):
    """The port's zamba2 step counts fewer flops than the reference's, by
    two ops of each Mamba layer's backward, and by nothing else:

      * the first chunk's carry is a zero constant in the port's Python
        chunk loop (``models/mamba.py``, ``ssd_chunked``), so autograd
        computes no gradient of it; the reference's ``lax.scan`` carries
        a traced state and XLA computes that dot: 2 * B * H * P * N * L;
      * the gradient of the chunk decays in the three-operand einsum
        ``bclhn,bhcl,bclhp->bchpn``: torch contracts it as a product and
        a sum (no dot), XLA as a dot over N: 2 * B * C * L * H * N.

    The forward counts are equal (``test_forward_flops_equal_the_reference``)."""
    cfg, ref, got = _step_flops("zamba2-1.2b", remat)
    s = cfg.ssm
    heads, chunk = s.n_heads(cfg.d_model), s.chunk
    layers = sum(k == "mamba" for k in cfg.layer_kinds())
    carry = 2 * BATCH * heads * s.head_dim * s.d_state * chunk
    decay = 2 * BATCH * (SEQ // chunk) * chunk * heads * s.d_state
    assert layers * (carry + decay) == 409_600
    assert ref - got == 409_600


def test_counts_equal_flop_counter_mode():
    cfg = registry.get_smoke_config("deepseek-v2-lite-16b")
    params = _port_params("deepseek-v2-lite-16b")
    _, pb = _batches(cfg)
    with torch.no_grad():
        with FlopCounterMode(display=False) as fc:
            lm_loss(params, pb, cfg)
        got = _analyze(lambda: lm_loss(params, pb, cfg)[0])
    assert got.flops == fc.get_total_flops()


def test_uncounted_names_matmul_like_ops_and_custom_ops():
    @torch.library.custom_op("repro_test::scale", mutates_args=())
    def scale(x: torch.Tensor) -> torch.Tensor:
        return x * 2

    m, v = torch.zeros(8, 4), torch.zeros(4)
    out = _analyze(lambda: (torch.mv(m, v), scale(v), m @ m.t()))
    assert out.uncounted == {"aten.mv": 1, "repro_test.scale": 1}
    assert out.flops == 2 * 8 * 4 * 8 and out.dot_count == 1


def test_peak_live_bytes_tracks_what_the_call_creates():
    x = torch.zeros(256, 256)                 # 256 KiB, an input

    def fn(t):
        a = t + 1                             # live: a
        b = a * 2                             # live: a, b
        del a
        return b - 1                          # live: b and the result

    out = _analyze(fn, x)
    assert out.peak_live_bytes == 2 * 256 * 256 * 4
