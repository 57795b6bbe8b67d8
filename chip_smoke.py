#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (the H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds every kernel against its plain PyTorch twin on the card at the
MNIST CapsuleNet's shapes (both routing schedules; the K2 GEMM also at
capsnet-svhn's PrimaryCaps shape, twice each for identical bits, then
timed beside ``F.conv2d`` and ``torch.addmm`` with a sweep of its split
of K; K3, K4, K5, K8/K9 and K14b, which route each sample over a
thread-block cluster, at MNIST batch 8 and 16, the smoke config, the
SVHN bottleneck and (K3, K8) the SVHN ResCaps half and ClassCaps, twice
each for identical bits, then swept over every cluster size beside the
plan's model and the card's co-resident clusters, the planned size
against the best, K8's and K9's replay and emit timed apart, and K3, K4,
K8 and K14b beside an empty launch of their grids), runs the
full-width forward on the pipelined and the per-op plan against the plain
forward, serves 32 seeded requests through ``CapsuleEngine`` on both
plans (no fault: no failure, trip or replan) and again under faults
(phase 5b: a ``vmem_shrink`` at tick 1 to 1/4, 1/8 and 1/16 of the
shared-memory budget replans onto K3, then K4, then trips the breaker
onto the plain forward; a NaN storm with a corrupted slot; a
``plan_error`` storm; each run's requests held to the plain forward,
its launches and ``check_engine_stats``), serves the full, 1/4 and 1/8
plans run by run in turns (req/s) beside their forwards' device time, and
times each kernel at the engine's batch (K1, the im2col copy,
at MNIST's and, in phase 12, SVHN's Conv1 and PrimaryCaps, and K7, the
col2im gather, at both PrimaryCaps dx: each held to its twin's bits
twice, then timed with the L2 warm and cold beside its byte bound and
one PyTorch call, the unfold copy or ``F.fold``).  Then it trains: the backward kernels (K6
dW, K7 col2im, K8/K9 routing backward on clusters) against their twins at the
training shapes (batch 16; K6 and the dpatches GEMM twice each for
identical bits, then timed, K6 also on 128 x 128 tiles only against its
plan), one full-width ``total_loss`` backward on both training plans
against the plain backend's autograd gradients, 20
SGD steps of ``CapsTrainLoop`` on the full-width network on each plan
(the loss must fall) and 4 on the CLI's default smoke config, and the
backward kernels' times.  Last, the split ClassCaps path (K14a caps_votes writing u_hat to
device memory, K14b routing reading it back on a cluster) and the standalone squash
(K10) with its backward: the path at full width (and one gradient of a
network whose capsule cannot fuse), each kernel against its twin (K14a
bit for bit), the split v against the fused kernel's, their times and
modeled bytes side by side, K14a and K10 also with the L2 cold beside an
empty launch of their grids (K14a beside einsum's device time), and
sweeps of K14a's rows a CTA and K10's lanes and rows a CTA.  Phase 12, deep stacks, runs the full-width SVHN
CapsuleNet (a plain bottleneck -- K5 on the pipelined plan, K4 streaming
its votes on a cluster on the per-op plan -- two reversible ResCaps
blocks, ClassCaps): its forward on both plans against the plain forward,
16 requests through the engine on both plans, the residual epilogue,
K3, K4, K5, K8 and K9 on their clusters, K4 with its logits in device
memory (K4g) and K13/K13b (the unfused oracle, on K4's and K9's
clusters) against their twins and, bit for bit, the fused kernels, one
training
gradient through the reversible segment K12 (and on the CIFAR-10 smoke
config), the SVHN smoke config's pipelined plan, 20 full-width training
steps on each plan, and the new kernels' times.  Phase 13, LM serving, frees the CapsuleNet's tensors and serves
``gemma2-9b`` at its published width (42 layers, 9.24 B parameters in
fp32, drawn on the card): K16 (RMSNorm) and K15 (flash attention) against
their twins at its shapes (prefill, a 4608-token window layer, decode at
mixed lengths, the Tq > Tk rows, and head dims 64 and 128; K15's split-KV
decode schedule at a 4608-key cache against its split twin at the planned
splits, and both schedules twice for identical bits), one
4608-token forward on the kernels backend against the plain one (logits
and argmax), 8 requests through ``ServeEngine`` three times: on the
kernels backend with each decode tick replayed as one CUDA graph (the
main path), on the kernels backend ticking eagerly, and on the plain
backend (the graph engine's tokens and finish order equal the eager
kernels engine's exactly, both equal the plain engine's up to ties; on
both kernels engines K15/K16 launches equal 42 and 169 per forward call,
every prefill on K15's prefill schedule and every decode tick on its
decode schedule), the engines' times tick by tick, a profiled replayed
tick (169 K16 and 42 K15 records, its device ms by kernel and the
device's idle share) beside a profiled eager tick, and both kernels'
times beside their bounds, twins and library calls, with K15's decode
sites swept over split counts and its prefill tile over head dims, and
K16's forms (row groups, the small-R form at each CTA size) over row
counts beside an empty launch of its decode grid.  The weights are random, made from a seed.
Every check that fails raises, so the script exits non-zero; it also
exits non-zero, printing no result, where no CUDA device is present or
the ``repro_torch`` package is not beside it.  It imports neither JAX nor
the JAX package.

The last line is ``{"ok": true, "device": {...}}``; the line before it
is a JSON object with each kernel's launches on the main path, its time,
its plain twin's time, the card's bound for the same work, and the time
of one PyTorch library call computing the same function where one exists.
"""

from __future__ import annotations

import contextlib
import gc
import io
import json
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
SLOTS = 8                       # the engine's batch: every timed shape uses it
N_REQUESTS = 32
TRAIN_BATCH = 16                # the trainer's batch: the backward's shapes
TRAIN_STEPS = 20
SVHN_REQUESTS = 16
# Phase 5b: the vmem_shrink factors the engine replans under at tick 1,
# the kernels it serves with, the requests of a timed run (this many
# times the seeded ones), the wall-clock seconds a timed round gives
# each plan (its runs interleaved with the other plans' one by one: a
# run of 256 takes ~40 ms, and the host's speed drifts by up to ~1.6x
# over seconds) and the rounds.
SHRINKS = (0.25, 0.125, 0.0625)
ENGINE_KERNELS = ("im2col_patches_f32", "matmul_bias_act_f32",
                  "primary_routing_f32", "votes_routing_cluster_f32",
                  "votes_routing_streamed_cluster_f32")
SERVE_REPEATS = 8
SERVE_WINDOW_S = 1.5
SERVE_ROUNDS = 4
# NVIDIA H100 SXM data sheet (dense, no sparsity), at its 700 W limit.
PEAK_FP32_FLOPS = 67e12         # fp32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12

# Cold-L2 times: a buffer this large is written before each timed launch,
# over twice the H100's 50 MB L2.
FLUSH_BYTES = 128 << 20
CARD = ""                       # nvidia-smi's name and power limit, set in main

# Tolerances of the kernel-vs-twin checks, with their reasons.
EXACT = (0.0, 0.0, "a gather copies values (K7: sums its taps in the "
         "twin's order): bit-identical")
FMA_CHAIN = (0.0, 0.0, "K14a sums c = 0..C-1 in fmaf from 0 and its twin "
             "repeats that chain (kernels/caps_votes.fmaf): bit-identical")
SHORT_SUM = (1e-5, 1e-5, "81-term fp32 dot products summed in another "
             "order (the reference's conv tolerance)")
LONG_SUM = (1e-4, 2e-5, "20,736-term fp32 dot products summed in another "
            "order: rounding grows like sqrt(K) * 2^-24 * sum|terms|")
ROUTING = (1e-4, 1e-5, "fp32 sums over up to 1152 capsules (and the "
           "20,736-term producer) in another order, through 3 routing "
           "iterations")
# Backward checks: max |got - want| over max |want|.  Gradients are sums of
# terms of both signs; an elementwise relative bound would fail on values
# that cancel to near zero, so the error is normalised by the largest one.
AT_B_SUM = (2e-5, "576- and 6400-term fp32 sums (K6's reduction, split "
            "across CTAs) in another order")
DPATCHES = (1e-5, "256-term fp32 dot products (the dpatches GEMM, K2) in "
            "another order")
GRAD = (1e-4, "fp32 backward through 3 routing iterations and sums over "
        "up to 1152 capsules, 16 samples and 20,736-term GEMMs, in "
        "another order")
SPLIT = (1e-4, 1e-5, "8-term votes, then sums over 1152 capsules through 3 "
         "routing iterations, in another order (the card tolerance of "
         "the routing checks)")
SQUASH = (1e-4, 1e-5, "a sum of up to 256 squares in another order, and "
          "rsqrtf")
# Phase 13, LM serving: gemma2-9b at its published width.
LM_ARCH = "gemma2-9b"
LM_PROMPT = 4608                # one prompt past the 4096-token window
LM_SLOTS = 4
LM_MAX_LEN = 512
LM_REQUESTS = 8
LM_NEW_TOKENS = 16
LM_PROMPT_LENGTHS = (17, 300)   # the engine's shortest and longest prompt
# K15's long-context decode site: 4 slots over a 4608-key cache, two rows
# past the 4096 window, one short, one nearly empty.
LM_LONG_DECODE = (LM_PROMPT, LM_PROMPT - 508, 300, 17)
SPLIT_SWEEP = (1, 2, 4, 8, 16, 32, 64)
RMS_NARROW_D = 1024             # K16's widest warp-a-row row, for its sweep
# Phase 2b wraps each profiled engine step in marker kernels (``traced``).
# On the H100 a torch.profiler session can lose records at its start:
# a few, more the older the process, and now and then the first ms or
# more.  The lead markers and the spin take that loss; the guards show
# whether it reached the step.
TRACE_LEAD = 64                 # frac_ kernels that open a session
TRACE_SPIN_CYCLES = 10_000_000  # then ~5 ms of device spin
TRACE_GUARD = 8                 # trunc_ kernels before the step, floor_ after
FLASH = (2e-5, 2e-5, "the reference's own (tests/test_kernels.py:173-174): "
         "fp32 logits over D <= 256 and sums over up to 4608 keys in "
         "another order")
RMS = (2e-5, 2e-5, "the reference's own fp32 tolerance: a sum of 3584 "
       "squares in another order, and rsqrtf")
RMS_BF16 = (2e-2, 2e-2, "the reference's bf16 tolerance: the output is "
            "rounded to bf16 once")
LOGITS = (1e-4, "fp32 through 42 layers, attention summed in another "
          "order (online softmax over 32-key tiles, decode over key "
          "splits)")


def check(name: str, got, want, tol) -> dict:
    import torch
    rtol, atol, reason = tol
    torch.cuda.synchronize()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}, or non-finite values")
    diff = (got - want).abs()
    max_abs = diff.max().item()
    max_rel = (diff / want.abs().clamp_min(1e-30)).max().item()
    ok = bool((diff <= atol + rtol * want.abs()).all())
    print(f"check {name}: max_abs {max_abs:.3e} max_rel {max_rel:.3e} "
          f"tol rtol={rtol:g} atol={atol:g} ({reason}) -> "
          f"{'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain twin")
    return {"max_abs": max_abs}


def check_scaled(name: str, got, want, tol) -> float:
    """max |got - want| / max |want| against ``tol = (bound, reason)``;
    returns the max absolute error."""
    import torch
    bound_, reason = tol
    torch.cuda.synchronize()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                             f"{tuple(want.shape)}, or non-finite values")
    max_abs = (got - want).abs().max().item()
    scale = want.abs().max().item()
    if scale == 0.0:
        raise AssertionError(f"{name}: the plain twin gave all zeros")
    rel = max_abs / scale
    ok = rel <= bound_
    print(f"check {name}: max_abs {max_abs:.3e} max|want| {scale:.3e} "
          f"normalised {rel:.3e} "
          f"bound {bound_:g} ({reason}) -> {'ok' if ok else 'MISMATCH'}",
          flush=True)
    if not ok:
        raise AssertionError(f"{name}: disagrees beyond {bound_:g}")
    return max_abs


def time_ms(fn, reps: int = 7) -> float:
    """Median per-call device time of ``fn`` over ``reps`` samples, each a
    run of back-to-back calls between two CUDA events (warm L2, as the
    serving loop finds it)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    inner = max(1, min(50, int(5e-3 / max(time.perf_counter() - t0, 1e-6))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    samples = []
    for _ in range(reps):
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / inner)
    return statistics.median(samples)


def kernel_ms(prof, reps: int) -> dict[str, float]:
    """Device ms per call by kernel name from a ``torch.profiler`` trace
    of ``reps`` calls: the mean of each kernel's records times its
    launches a call (its records over ``reps``, rounded).  Where the
    trace keeps fewer records than there were launches, a plain sum over
    the records kept would read low; each such kernel is printed."""
    from torch.autograd import DeviceType
    out: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.device_time_total <= 0:
            continue
        per_call = max(1, round(e.count / reps))
        if e.count != per_call * reps:
            print(f"trace: {e.count} records of {per_call * reps} launches "
                  f"of {e.key[:60]}", flush=True)
        out[e.key] = (out.get(e.key, 0.0)
                      + e.device_time_total / e.count * per_call / 1e3)
    return out


def device_ms(fn, reps: int = 20) -> float | None:
    """Device time per call of ``fn``: the CUDA kernel time that
    ``torch.profiler`` (CUPTI) records over ``reps`` calls, per call
    (``kernel_ms``).  Unlike ``time_ms`` it leaves out the host's
    dispatch, which sets the pace of back-to-back calls of a kernel
    shorter than it.  None (printed as not measured) where the trace
    holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(kernel_ms(prof, reps).values())
    except (RuntimeError, AssertionError) as err:  # no CUPTI trace here
        print(f"device_ms: not measured ({type(err).__name__}: {err})",
              flush=True)
        return None
    return total if total > 0 else None


def device_breakdown(fn, reps: int = 3, top: int = 10) -> dict | None:
    """Device ms per call of ``fn`` by kernel name (the ``top`` largest),
    from a ``torch.profiler`` trace of ``reps`` calls; None where the
    trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times: dict[str, float] = {}
        for key, ms in kernel_ms(prof, reps).items():
            times[key[:72]] = times.get(key[:72], 0.0) + ms
    except (RuntimeError, AssertionError) as err:
        print(f"device_breakdown: not measured ({type(err).__name__}: "
              f"{err})", flush=True)
        return None
    if not times:
        return None
    ranked = sorted(times.items(), key=lambda kv: -kv[1])
    return dict(ranked[:top], total=sum(times.values()))


def replay_emit_ms(fn) -> dict:
    """Device ms per call of the cluster backward's two kernels (K8/K9),
    the replay and the per-capsule emit, from one profile of ``fn``; None
    (not measured) for a kernel of which the trace kept no record."""
    split_ = device_breakdown(fn, reps=20) or {}

    def of(name):
        times = [v for k, v in split_.items() if name in k]
        return sum(times) if times else None
    return dict(replay_device_ms=of("routing_bwd_cluster_kernel"),
                emit_device_ms=of("routing_bwd_emit_kernel"))


def cold_device_ms(fn, kernel: str, reps: int = 10,
                   clean: bool = False) -> float | None:
    """Device ms per call of the kernels whose names hold ``kernel``, from
    a ``torch.profiler`` trace of ``reps`` calls of ``fn``, each after
    writing ``FLUSH_BYTES`` (so each call finds the L2 cold and its
    inputs in device memory; the L2 full of dirty lines, which the call's
    own traffic writes back) or, with ``clean``, after reading them (the
    L2 cold and clean); only those kernels' records are counted.  None
    (not measured) where the trace holds none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")
    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                if clean:
                    flush.sum()
                else:
                    flush.fill_(1.0)
                fn()
            torch.cuda.synchronize()
        times = [ms for key, ms in kernel_ms(prof, reps).items()
                 if kernel in key]
    except (RuntimeError, AssertionError) as err:
        print(f"cold_device_ms: not measured ({type(err).__name__}: {err})",
              flush=True)
        return None
    return sum(times) if times else None


def im2col_unfold(x, kh: int, kw: int, stride: int):
    """K1's function in one PyTorch call, a strided copy: x [B, H, W, C]
    -> [B, OH*OW, KH*KW*C] with (kh, kw, c)-major columns.  K1's library
    yardstick: timed here, called nowhere in the port."""
    b, c = x.shape[0], x.shape[3]
    win = x.unfold(1, kh, stride).unfold(2, kw, stride)  # [B,OH,OW,C,kh,kw]
    return win.permute(0, 1, 2, 4, 5, 3).reshape(
        b, win.shape[1] * win.shape[2], kh * kw * c)


def fold_input(dp, kh: int, kw: int):
    """K7's input dp [B, P, KH*KW*C] in ``F.fold``'s layout [B, C*KH*KW,
    P] (its library yardstick's input, made before timing)."""
    b, p, k = dp.shape
    c = k // (kh * kw)
    return dp.reshape(b, p, kh * kw, c).permute(0, 3, 2, 1).reshape(
        b, c * kh * kw, p).contiguous()


def gather_extras(row: dict, fn, lib, kernel: str) -> dict:
    """A K1/K7 site's cold-L2 device time (``cold_device_ms``), its
    library call's device time and both times' share of the byte bound;
    printed beside the card's name and power limit."""
    cold = cold_device_ms(fn, kernel)
    extra = dict(cold_device_ms=cold, library_device_ms=device_ms(lib),
                 warm_share=(row["bound_ms"] / row["device_ms"]
                             if row["device_ms"] else None),
                 cold_share=row["bound_ms"] / cold if cold else None)

    def pct(x):
        return "not measured" if x is None else f"{100 * x:.0f}%"
    in_l2 = (extra["warm_share"] or 0) > 1
    print(f"{kernel} {row['op']}: device {row['device_ms']} ms warm "
          f"({pct(extra['warm_share'])} of the byte bound"
          f"{': above 100%, the writes landed in L2' if in_l2 else ''}), "
          f"{cold} ms cold ({pct(extra['cold_share'])}), bound "
          f"{row['bound_ms']:.5f} ms; library "
          f"{extra['library_device_ms']} ms device; plain "
          f"{row['plain_ms']:.4f} ms; on {CARD}", flush=True)
    return extra


def k1_site(label: str, path: str, x, k: int, stride: int) -> tuple:
    """A timed K1 site, ``(op, path, kernel, plain, library, bytes, flops,
    extras)``: the image read once and the patches written once, the
    unfold copy as the library call, and the cold-L2 extras."""
    from repro_torch.kernels import conv_im2col as k12
    oh, ow = ((n - k) // stride + 1 for n in x.shape[1:3])
    nbytes = 4.0 * (x.numel() + x.shape[0] * oh * ow * k * k * x.shape[3])

    def fn():
        return k12.im2col_patches(x, kh=k, kw=k, stride=stride)

    def lib():
        return im2col_unfold(x, k, k, stride)
    return (label, path, fn,
            lambda: k12.im2col_patches_plain(x, kh=k, kw=k, stride=stride),
            lib, nbytes, 0.0,
            lambda row: gather_extras(row, fn, lib, "im2col_kernel"))


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def summed(values) -> float | None:
    """Sum of ``values``, None when any is None (not measured)."""
    values = list(values)
    return None if any(v is None for v in values) else sum(values)


def routing_flops(b, i, c, jd, iters) -> float:
    """Votes once, then each routing pass's couplings and s."""
    return 2.0 * b * i * jd * (c + 2 * iters + 1)


def routing_bwd_flops(b, i, c, jd, iters) -> float:
    """The routing backward's own work: the votes once (a streamed
    schedule's recomputations are its cost, not the function's), the
    replayed routing, the seed/reverse rows and the du/dW emit."""
    votes = 2.0 * b * i * jd * c
    route = (iters + 1) * 4.0 * b * i * jd + 6.0 * b * i * jd
    emit = 3.0 * b * i * jd + 4.0 * b * i * jd * c
    return votes + route + emit


def routing_bwd_bytes(uu, ww) -> float:
    """u and W read, du and dW written, the cotangent read."""
    return 4.0 * 2 * (uu.numel() + ww.numel()) + 4.0 * uu.shape[0] * \
        ww.shape[1]


def conv_inputs(cfg, params, images):
    """The plain path's Conv1 output and squashed PrimaryCaps capsules."""
    import torch
    from repro_torch.core import capsnet
    from repro_torch.kernels.ref import squash
    x1 = torch.relu(capsnet._conv_nhwc(images, params["conv1_w"],
                                       params["conv1_b"], 1))
    pre = capsnet._conv_nhwc(x1, params["pc_w"], params["pc_b"],
                             cfg.pc_stride)
    return x1, squash(pre.reshape(images.shape[0], cfg.num_primary,
                                  cfg.primary_dim))


def conv_patches(cfg, params, images):
    """The PrimaryCaps patches [B, P, K] of the plain path's Conv1 output
    (K5's input)."""
    from repro_torch.kernels.conv_im2col import im2col_patches_plain
    x1, _ = conv_inputs(cfg, params, images)
    return im2col_patches_plain(x1, kh=cfg.pc_kernel, kw=cfg.pc_kernel,
                                stride=cfg.pc_stride)


def gemm_extras(row: dict, lib, *, split_k: int, ctas: int,
                addmm) -> dict:
    """A GEMM site's split and grid, and the device times of its library
    call and of ``torch.addmm`` (timed here, never called by the port);
    printed beside the kernel's."""
    extra = dict(split_k=split_k, ctas=ctas, addmm_ms=time_ms(addmm),
                 addmm_device_ms=device_ms(addmm),
                 library_device_ms=device_ms(lib) if lib else None)
    print(f"{row['op']}: split_k {split_k}, {ctas} CTAs, device "
          f"{row['device_ms']} ms (bound {row['bound_ms']:.4f}); library "
          f"{extra['library_device_ms']} ms, addmm "
          f"{extra['addmm_device_ms']} ms device", flush=True)
    return extra


def equal_bits(name: str, got, want) -> None:
    """Fail unless ``got`` and ``want`` (a tensor or a tuple of them) hold
    the same bits."""
    import torch
    torch.cuda.synchronize()
    pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
    if not all(torch.equal(a, b) for a, b in pairs):
        raise AssertionError(f"{name}: different bits")
    print(f"check {name}: identical bits -> ok", flush=True)


def same_bits(name: str, fn):
    """Call ``fn`` twice; fail unless both results (a tensor or a tuple of
    them) hold the same bits.  Returns the first."""
    first = fn()
    equal_bits(f"{name}: two launches", first, fn())
    return first


def cluster_sweep(label: str, plan_at, run, occupancy) -> dict:
    """Device ms of a cluster kernel at every cluster size its plan allows
    (``plan_at(cs)``: the schedule at that size, None where none fits)
    and the card's co-resident clusters and registers; one printed line
    per size, with the plan's modeled waves and time beside them."""
    from repro_torch.core import execplan
    out = {}
    for cs in execplan.CLUSTER_SIZES:
        sched = plan_at(cs)
        if sched is None:
            print(f"{label} cluster {cs}: no schedule fits", flush=True)
            continue
        occ = occupancy(sched, cs)
        t = device_ms(lambda: run(sched, cs), reps=5)
        out[str(cs)] = dict(mode=sched.mode, block_i=sched.block_i,
                            device_ms=t,
                            max_active_clusters=occ["max_active_clusters"],
                            registers=occ["registers"])
        print(f"{label} cluster {cs}: {sched.mode} block_i "
              f"{sched.block_i}, {sched.smem_bytes} B a CTA, "
              f"{occ['max_active_clusters']} clusters at once "
              f"({occ['registers']} registers), {sched.cluster.waves} "
              f"modeled waves: device {t} ms, model "
              f"{1e3 * sched.seconds:.4f} ms", flush=True)
    return out


def k3_twin(u, w, r, cluster: int, *, iters: int, num_classes: int):
    """K3's plain twin: the cluster's rank-order routing of resident votes
    (``cluster_routing_plain``), plus the residual ``r`` when given."""
    from repro_torch.kernels import votes_routing as k34
    v = k34.cluster_routing_plain(u, w, iters=iters, num_classes=num_classes,
                                  mode="resident", block_i=u.shape[1],
                                  cluster=cluster)
    return v if r is None else v + r


def empty_floor(bsz: int, cluster: int, smem: int) -> dict:
    """Time of an empty launch of ``bsz`` clusters of ``cluster`` CTAs with
    ``smem`` bytes of shared memory each: CUDA events over back-to-back
    launches (the host's dispatch rate) and the profiler's device time
    (the floor under a kernel of that grid, beside its byte bound)."""
    import torch
    from repro_torch.kernels import votes_routing as k34
    dev = torch.device("cuda")

    def go():
        k34.empty_launch(bsz, cluster, smem, dev)
    return dict(grid=[bsz, cluster, smem], ms=time_ms(go),
                device_ms=device_ms(go))


def grid_floor(ctas: int, threads: int) -> dict:
    """Time of an empty launch of ``ctas`` CTAs of ``threads`` threads (no
    shared memory, no cluster): CUDA events over back-to-back launches
    and the profiler's device time, the floor under a kernel of that
    grid."""
    import torch
    from repro_torch.kernels import rmsnorm as k16
    dev = torch.device("cuda")

    def go():
        k16.empty_launch(ctas, threads, dev)
    return dict(grid=[ctas, threads], ms=time_ms(go),
                device_ms=device_ms(go))


def print_site(kernel: str, row: dict) -> None:
    """One line for a timed K14a/K10 site: device ms warm and cold, each
    as a share of the byte bound, against an empty launch of its grid and
    the library call's device ms, on the card."""
    def share(t):
        return "not measured" if not t else f"{100 * row['bound_ms'] / t:.0f}%"

    def ratio(a, b):
        return "not measured" if a is None or not b else f"{a / b:.2f}x"
    empty = row["empty_launch"]
    print(f"{kernel} {row['op']}: device {row['device_ms']} ms warm "
          f"({share(row['device_ms'])} of the bound), "
          f"{row['cold_device_ms']} ms cold "
          f"({share(row['cold_device_ms'])}), bound "
          f"{row['bound_ms']:.6f} ms ({row['bound_by']}); empty launch of "
          f"its grid {empty['grid']}: {empty['device_ms']} ms device "
          f"(the kernel {ratio(row['device_ms'], empty['device_ms'])} of "
          f"it); library {row['library_device_ms']} ms device; on {CARD}",
          flush=True)


def sweep_miss(label: str, sweep: dict, planned: int) -> dict:
    """The plan's cluster size against the best of a ``cluster_sweep``:
    printed, and returned as ``{planned, best, miss}`` (the planned size's
    device time over the best's, less one)."""
    times = {int(cs): r["device_ms"] for cs, r in sweep.items()
             if r["device_ms"] is not None}
    if planned not in times:
        print(f"{label}: the planned cluster {planned} was not measured",
              flush=True)
        return {}
    best = min(times, key=times.get)
    miss = times[planned] / times[best] - 1.0
    print(f"{label}: planned cluster {planned} ({times[planned]} ms), best "
          f"{best} ({times[best]} ms): {100 * miss:.1f}% over the best",
          flush=True)
    return dict(planned=planned, best=best, miss=miss)


def svhn_pc_inputs(dev):
    """Seeded inputs of the PrimaryCaps conv at capsnet-svhn's serving
    shape: a non-negative Conv1 output (a ReLU's) [SLOTS, 24, 24, 256],
    He-normal HWIO weights and a small bias."""
    import numpy as np
    import torch
    from repro_torch.configs import capsnet_svhn
    cfg = capsnet_svhn.config()
    k = cfg.pc_kernel ** 2 * cfg.conv1_channels
    rng = np.random.default_rng(SEED + 7)
    x = torch.tensor(rng.random((SLOTS, cfg.conv1_out, cfg.conv1_out,
                                 cfg.conv1_channels), np.float32), device=dev)
    w = torch.tensor((2.0 / k) ** 0.5 * rng.standard_normal(
        (cfg.pc_kernel, cfg.pc_kernel, cfg.conv1_channels, cfg.pc_channels),
        np.float32), device=dev)
    b = torch.tensor(0.1 * rng.standard_normal(cfg.pc_channels, np.float32),
                     device=dev)
    return x, w, b


def timed_sites(sites) -> list[dict]:
    """Time each ``(op, fn, plain, library, bytes, flops)`` site: the
    kernel (CUDA events and profiler), its plain twin, the library call,
    and the card's bound for its work."""
    site_rows = []
    for (op, fn, plain, lib, nbytes, flops) in sites:
        bms, by = bound(nbytes, flops)
        site_rows.append(dict(
            op=op, ms=time_ms(fn), device_ms=device_ms(fn),
            plain_ms=time_ms(plain),
            library_ms=time_ms(lib) if lib is not None else None,
            bound_ms=bms, bound_by=by, bytes=nbytes, flops=flops))
    return site_rows


def same_predictions(name: str, lengths_k, lengths_t, atol: float) -> None:
    """Predictions must agree, except where the plain lengths of the two
    classes are within ``atol`` of each other (a tie at fp32 tolerance)."""
    pk, pt = lengths_k.argmax(-1), lengths_t.argmax(-1)
    ties = 0
    for i in range(len(pk)):
        if pk[i] != pt[i]:
            gap = abs(float(lengths_t[i, pt[i]] - lengths_t[i, pk[i]]))
            if gap > atol:
                raise AssertionError(f"{name}: sample {i} predicts "
                                     f"{int(pk[i])}, plain {int(pt[i])}")
            ties += 1
    print(f"check {name}: predictions equal on {len(pk) - ties}/{len(pk)}, "
          f"{ties} ties within {atol:g}", flush=True)


def fault_free(label: str, stats: dict) -> None:
    """A run with no fault injected: no forward failed, nothing replanned,
    the breaker never tripped (so it hid no kernel that failed to
    launch), and the counters add up."""
    from repro_torch.verify import check_engine_stats
    bad = {k: stats[k] for k in ("forward_failures", "breaker_trips",
                                 "replans", "degraded") if stats[k]}
    problems = check_engine_stats(stats)
    if bad or problems:
        raise AssertionError(f"{label}: a fault-free run shows {bad} "
                             f"{problems}")


def serve_checked(label: str, engine, reqs, plain_len, specs=(),
                  first_ticks: int = 0) -> tuple[dict, list[dict]]:
    """Serve ``reqs`` through ``engine`` with the fault ``specs`` injected:
    every request must end ``ok`` with the plain forward's prediction
    (``plain_len``, at ``ROUTING``'s tolerance), and ``stats()`` must pass
    ``check_engine_stats``.  Returns the stats and the kernels' launches
    in the first ``first_ticks`` ticks and in the rest of the run, each
    counted from 0."""
    import numpy as np
    import torch
    from repro_torch.core import faults
    from repro_torch.kernels import build
    from repro_torch.serve.capsule import CapsRequest
    from repro_torch.verify import check_engine_stats

    for i, r in enumerate(reqs):
        engine.submit(CapsRequest(rid=i, image=r.image))
    counts = []
    with faults.inject(*specs) as reg:
        build.reset_launch_counts()
        for _ in range(first_ticks):
            engine.step()
        torch.cuda.synchronize()
        counts.append(build.launch_counts())
        build.reset_launch_counts()
        done = engine.run()
        torch.cuda.synchronize()
        counts.append(build.launch_counts())
    stats = engine.stats()
    print(f"serve {label}: fired {reg.fired}", flush=True)
    print(f"serve {label}: {json.dumps(stats)}", flush=True)
    problems = check_engine_stats(stats)
    if problems:
        raise AssertionError(f"serve {label}: {problems}")
    if len(done) != len(reqs) or any(r.status != "ok" for r in done):
        raise AssertionError(f"serve {label}: statuses "
                             f"{[(r.rid, r.status) for r in done]}")
    got = torch.tensor(np.stack([r.lengths for r in sorted(
        done, key=lambda r: r.rid)]))
    check(f"serve {label} lengths", got, plain_len, ROUTING)
    same_predictions(f"serve {label}", got, plain_len, ROUTING[1])
    print(f"serve {label}: {len(done)} requests ok, "
          f"{stats['requests_per_s']:.1f} req/s, mean latency "
          f"{stats['mean_latency_ms']:.2f} ms; launches in the first "
          f"{first_ticks} ticks {json.dumps(counts[0])}, then "
          f"{json.dumps(counts[1])}", flush=True)
    return stats, counts


def degraded_serving(dev, params, cfg, reqs, plain_len, images) -> dict:
    """Phase 5b: the hardened engine at MNIST's full width.  A
    ``vmem_shrink`` at tick 1 by each of ``SHRINKS`` replans under the
    reduced shared-memory budget -- K3 serves after 1/4, K4 (and no K3)
    after 1/8, and 1/16 trips the breaker onto the plain forward, after
    which no hand-written kernel launches -- with each routing op's
    planned footprint held to the budget and to the kernel's own layout;
    a NaN storm over ticks 0-1 with a corrupted slot at tick 2 ends every
    request ``ok`` through retries; a ``plan_error`` storm of
    ``breaker_after`` ticks trips the breaker.  Then the full, 1/4 and 1/8
    plans serve in ``SERVE_ROUNDS`` rounds after a warm-up run of each:
    a round serves runs of ``SERVE_REPEATS`` times the requests, each on
    a new engine and each held to the plain forward, one run of each
    plan a cycle in an order rotated each cycle, until ``SERVE_WINDOW_S``
    a plan have passed; a plan's req/s in a round is its requests over
    its engines' summed elapsed time.  Their forwards are
    profiled (device ms).
    Whether the 1/4 plan serves faster than the full one is resolved when
    it is on the same side in every round (its req/s over the full
    plan's of that round).  Returns each shrink run's launches after the shrink,
    by run."""
    import ctypes
    import dataclasses

    import torch
    from repro_torch.core import capsnet, execplan, faults
    from repro_torch.core.planner import SMEM_BYTES
    from repro_torch.kernels import build
    from repro_torch.kernels import votes_routing as k34
    from repro_torch.serve.capsule import CapsuleEngine

    k3_bytes = build._library(
        "votes_routing").votes_routing_cluster_smem_bytes
    k3_bytes.argtypes, k3_bytes.restype = [ctypes.c_int] * 8, ctypes.c_int
    layers = {lay.name: lay for lay in cfg.routing_stack()}

    def engine(**kw):
        return CapsuleEngine(params, cfg, slots=SLOTS, backend="kernels",
                             device=dev, **kw)

    after = {}
    for factor in SHRINKS:
        label = f"vmem_shrink {factor}"
        eng = engine()
        budget = int(eng._orig_budget * factor)
        stats, (first, rest) = serve_checked(
            label, eng, reqs, plain_len, [faults.FaultSpec(
                site=faults.SITE_ENGINE_TICK, kind="vmem_shrink", at=1,
                times=1, factor=factor)], first_ticks=1)
        after[label] = rest
        forwards = eng.ticks - 1
        if first["primary_routing_f32"] != 1 or stats["smem_budget"] \
                != budget:
            raise AssertionError(f"{label}: tick 0 ran {first}, budget "
                                 f"{stats['smem_budget']} != {budget}")
        if eng.plan is None:             # nothing fits: the breaker
            if (stats["breaker_trips"], stats["replans"]) != (1, 0) or \
                    eng._backend != "torch" or any(rest.values()):
                raise AssertionError(f"{label}: expected the breaker and "
                                     f"no kernel after it: {stats}, {rest}")
            print(f"serve {label}: {budget} B fits no plan, the breaker "
                  f"serves {forwards} ticks on the plain forward, no "
                  f"kernel launched after tick 0", flush=True)
            continue
        report = eng.degrade_report
        print(f"serve {label}: DegradeReport "
              f"{json.dumps(dataclasses.asdict(report))}; plan "
              f"{json.dumps(eng.plan.summary())}", flush=True)
        routing = eng.plan.op(execplan.FUSED_NAME)
        want_k3 = forwards if routing.mode == "resident" else 0
        want_k4 = forwards if routing.mode == "streamed" else 0
        if (stats["replans"], stats["breaker_trips"]) != (1, 0) \
                or eng.plan.pipelined or rest["primary_routing_f32"] \
                or rest["votes_routing_cluster_f32"] != want_k3 \
                or rest["votes_routing_streamed_cluster_f32"] != want_k4 \
                or rest["matmul_bias_act_f32"] != 2 * forwards \
                or rest["im2col_patches_f32"] != 2 * forwards:
            raise AssertionError(f"{label}: {stats}, launches {rest}")
        for op in eng.plan.ops:
            if op.kernel != "votes_routing":
                continue
            lay = layers[op.name]
            layout = k3_bytes(lay.in_caps, lay.in_dim, lay.num_caps,
                              lay.caps_dim, op.cluster,
                              int(op.mode == "resident"), op.block_i,
                              int(op.mode == execplan.STREAMED_GLOBAL))
            occ = k34.cluster_occupancy(
                lay.in_caps, lay.in_dim, lay.num_caps, lay.caps_dim,
                cluster=op.cluster, mode=op.mode, block_i=op.block_i)
            print(f"serve {label}: {op.name} {op.mode}, block_i "
                  f"{op.block_i}, clusters of {op.cluster}: planned "
                  f"{op.smem_bytes} B, the kernel's layout {layout} B, "
                  f"budget {budget} B, occupancy {json.dumps(occ)}",
                  flush=True)
            if not (op.smem_bytes == layout == occ["max_dynamic_smem"]
                    <= budget) or occ["max_active_clusters"] < 1:
                raise AssertionError(f"{label}: {op.name}'s footprint")
    eng = engine()
    stats, (_, counts) = serve_checked(
        "nan_output storm + slot_corrupt", eng, reqs, plain_len, [
            faults.FaultSpec(site=faults.SITE_ENGINE_FORWARD,
                             kind="nan_output", at=0, times=2),
            faults.FaultSpec(site=faults.SITE_ENGINE_TICK,
                             kind="slot_corrupt", at=2, times=1,
                             seed=SEED)])
    if stats["retries"] < SLOTS + 1 or stats["forward_failures"] \
            or stats["poisoned"] < SLOTS + 1 \
            or counts["primary_routing_f32"] < 1:
        raise AssertionError(f"nan_output storm: {stats}, {counts}")
    eng = engine()
    stats, (_, counts) = serve_checked(
        "plan_error storm", eng, reqs, plain_len, [faults.FaultSpec(
            site=faults.SITE_ENGINE_FORWARD, kind="plan_error", at=0,
            times=eng.breaker_after)])
    if (stats["forward_failures"], stats["breaker_trips"]) != (
            eng.breaker_after, 1) or not stats["degraded"] \
            or any(counts.values()):
        raise AssertionError(f"plan_error storm: {stats}, {counts}")

    # The full, 1/4 and 1/8 plans serving in turns, and their forwards'
    # device time.
    plans = {f"{f} budget": execplan.compile_plan(
        cfg, batch=SLOTS, smem_budget=int(SMEM_BYTES * f), pipeline=True)
        for f in (1.0, 0.25, 0.125)}
    serving = {label: [] for label in plans}
    for label, p in plans.items():       # warm: each plan's first launches
        serve_checked(f"{label} plan, warm-up", engine(plan=p), reqs,
                      plain_len)
    labels = list(plans)
    timed_len = torch.cat([plain_len] * SERVE_REPEATS)
    for k in range(SERVE_ROUNDS):
        tally = {label: [0, 0.0, 0] for label in labels}
        start, cycle = time.perf_counter(), 0
        while time.perf_counter() - start < SERVE_WINDOW_S * len(labels):
            # One run of each plan a cycle, the order rotated each cycle.
            for label in labels[cycle % 3:] + labels[:cycle % 3]:
                with contextlib.redirect_stdout(io.StringIO()):
                    stats, _ = serve_checked(
                        f"{label} plan, timed", engine(plan=plans[label]),
                        reqs * SERVE_REPEATS, timed_len)
                fault_free(f"{label} plan", stats)
                tally[label][0] += stats["requests"]
                tally[label][1] += stats["elapsed_s"]
                tally[label][2] += 1
            cycle += 1
        for label, (served, secs, runs) in tally.items():
            serving[label].append(served / secs)
            print(f"serve {label} plan, timed round {k}: {runs} runs, "
                  f"{served} requests ok in {secs:.4f} s of serving: "
                  f"{served / secs:.1f} req/s", flush=True)
    with torch.no_grad():
        for label, p in plans.items():
            fwd = (lambda p=p: capsnet.forward(
                params, images, cfg, backend="kernels", plan=p, device=dev))
            kind = "pipelined" if p.pipelined else "per-op"
            runs = serving[label]
            print(f"degraded plans: {label} ({kind}): serving median "
                  f"{statistics.median(runs):.1f} req/s of "
                  f"{json.dumps(runs)} (spread "
                  f"{(max(runs) - min(runs)) / statistics.median(runs):.4f}"
                  f" of the median), forward device ms {device_ms(fwd)}, "
                  f"by kernel {json.dumps(device_breakdown(fwd))}; "
                  f"on {CARD}", flush=True)
    gain = [q / f for q, f in zip(serving["0.25 budget"],
                                  serving["1.0 budget"])]
    verdict = ("resolved: the 1/4 plan serves faster" if min(gain) > 1
               else "resolved: the 1/4 plan serves slower" if max(gain) < 1
               else "unresolved: the rounds disagree")
    print(f"degraded plans: the 1/4 plan's req/s over the full plan's, by "
          f"round {json.dumps(gain)}: {verdict}", flush=True)
    return after


def deep_stacks(dev, rng, rows: list[dict], mnist: dict) -> None:
    """Phase 12, deep stacks, at the full width of ``capsnet-svhn``: 32x32x3
    -> Conv1 -> PrimaryCaps (2048 capsules of 8D) -> the plain bottleneck
    routed to 64 x 8D (K5 on the pipelined plan; on the per-op plan K4,
    its votes streamed on a cluster whose CTAs hold their rows' logits)
    -> two reversible ResCaps blocks (K3 with the
    residual epilogue on clusters, inside the K12 segment; K8 in its
    backward) -> ClassCaps (K3).  The forward at the engine's batch
    against the plain forward, 16 requests through the engine, each new
    kernel (K4 also with streamed-global named, and K13/K13b, the unfused
    oracle on K4's and K9's clusters, at the MNIST and the bottleneck
    shapes) against its twin and, bit for bit, the fused kernel, one
    training gradient through K12 (and on the CIFAR-10 smoke
    config's all-residual segment), the SVHN smoke config's pipelined plan
    (K5 with J = 16), 20 training steps, and the new kernels' times.
    Appends the new kernels' rows to ``rows``; ``mnist`` holds the MNIST
    ClassCaps inputs and schedules (K3's, K4's and K13's sites there)."""
    import numpy as np
    import torch

    from repro_torch.configs import capsnet_cifar10, capsnet_svhn
    from repro_torch.core import capsnet, execplan
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import primary_routing as k5
    from repro_torch.kernels import votes_routing as k34
    from repro_torch.serve.capsule import CapsRequest, CapsuleEngine
    from repro_torch.train import capsnet_loop

    GLOBAL, ORACLE = execplan.STREAMED_GLOBAL, execplan.ORACLE_MODE
    tb = TRAIN_BATCH
    cfg = capsnet_svhn.config()
    params = capsnet.init_params(torch.Generator().manual_seed(SEED + 3),
                                 cfg, device=dev)
    hw, ch = cfg.image_hw, cfg.in_channels

    def uniform(*shape):
        return torch.tensor(rng.random(shape, np.float32), device=dev)

    def randn(*shape, scale=1.0):
        return torch.tensor(scale * rng.standard_normal(shape, np.float32),
                            device=dev)

    images, timages = uniform(SLOTS, hw, hw, ch), uniform(tb, hw, hw, ch)
    labels = torch.tensor(rng.integers(0, cfg.num_classes, tb), device=dev)
    plan = execplan.compile_plan(cfg, batch=SLOTS, pipeline=True)
    pplan = execplan.compile_plan(cfg, batch=SLOTS, pipeline=False)
    tplan = execplan.compile_plan(cfg, batch=tb, pipeline=True, train=True)
    for name, p in (("SVHN serving", plan), ("SVHN serving per-op", pplan),
                    ("SVHN train", tplan)):
        print(f"plan {name}: pipelined={p.pipelined}, ops " + json.dumps(
            [(o.name, o.kernel, o.mode, o.block_i, o.smem_bytes, o.cluster)
             for o in p.ops]), flush=True)
    stack = cfg.routing_stack()
    lay0, half, final = stack[0], stack[1], stack[-1]
    neck, nbwd = pplan.op(lay0.name), tplan.bwd_op(lay0.name)
    spr = plan.op(execplan.PIPE_NAME)
    hop, fop = plan.op(half.name), plan.op(final.name)
    hbwd = tplan.bwd_op(half.name)
    if not plan.pipelined or neck.mode != "streamed" or not neck.cluster \
            or not nbwd.cluster:
        raise AssertionError("SVHN plans: expected K5 on the pipelined "
                             "plan, K4 streamed on a cluster on the per-op "
                             "plan and K9 on a cluster")
    if any(op.mode != "resident" or op.cluster is None
           for p in (plan, pplan, tplan) for lay in stack[1:]
           for op in (p.op(lay.name), p.bwd_op(lay.name)) if op):
        raise AssertionError("SVHN plans: expected K3 and K8 (the ResCaps "
                             "halves and ClassCaps) on clusters")

    def w_of(lay_):
        return params[lay_.param].reshape(lay_.in_caps, lay_.jd, lay_.in_dim)

    w0, wf, wfin = w_of(lay0), w_of(half), w_of(final)

    # The forward at the engine's batch on both plans against the plain
    # forward, with the launches each plan must make.
    with torch.no_grad():
        ref_out = capsnet.forward(params, images, cfg, backend="torch",
                                  device=dev)
        for label, p, want_counts in (
                ("pipelined", plan, (
                    ("im2col_patches_f32", 2), ("matmul_bias_act_f32", 1),
                    ("primary_routing_f32", 1),
                    ("votes_routing_global_cluster_f32", 0),
                    ("votes_routing_cluster_f32", 5),
                    ("votes_routing_streamed_cluster_f32", 0),
                    ("votes_routing_2pass_f32", 0))),
                ("per-op", pplan, (
                    ("im2col_patches_f32", 2), ("matmul_bias_act_f32", 2),
                    ("primary_routing_f32", 0),
                    ("votes_routing_global_cluster_f32", 0),
                    ("votes_routing_cluster_f32", 5),
                    ("votes_routing_streamed_cluster_f32", 1),
                    ("votes_routing_2pass_f32", 0)))):
            build.reset_launch_counts()
            out = capsnet.forward(params, images, cfg, backend="kernels",
                                  plan=p, device=dev)
            torch.cuda.synchronize()
            fwd_counts = build.launch_counts()
            print(f"svhn forward {label}: launches {fwd_counts}", flush=True)
            for key in ("class_caps", "lengths", "reconstruction"):
                check(f"svhn forward {label} {key}", out[key], ref_out[key],
                      ROUTING)
            for key in ("class_caps", "lengths"):  # small at this init
                err = (out[key] - ref_out[key]).abs().max().item()
                scale = ref_out[key].abs().max().item()
                print(f"svhn forward {label} {key}: max|want| {scale:.3e}, "
                      f"max_abs {err:.3e}, normalised {err / scale:.3e}",
                      flush=True)
            same_predictions(f"svhn forward {label}", out["lengths"].cpu(),
                             ref_out["lengths"].cpu(), ROUTING[1])
            for sym, n in want_counts:
                if fwd_counts[sym] != n:
                    raise AssertionError(
                        f"svhn forward {label}: {sym} launched "
                        f"{fwd_counts[sym]} times, not {n}")

    # Serve seeded requests through the engine on both plans.
    reqs = [CapsRequest(rid=i, image=rng.random((hw, hw, ch), np.float32))
            for i in range(SVHN_REQUESTS)]
    with torch.no_grad():
        all_imgs = torch.tensor(np.stack([r.image for r in reqs]),
                                device=dev)
        plain_len = capsnet.forward(params, all_imgs, cfg, backend="torch",
                                    device=dev)["lengths"].cpu()
    served = {}
    for label, plan_, sym in (("pipelined", plan, "primary_routing_f32"),
                              ("per-op", pplan,
                               "votes_routing_streamed_cluster_f32")):
        engine = CapsuleEngine(params, cfg, slots=SLOTS, backend="kernels",
                               device=dev, plan=plan_)
        build.reset_launch_counts()
        for r in reqs:
            engine.submit(CapsRequest(rid=r.rid, image=r.image))
        done = engine.run()
        torch.cuda.synchronize()
        served[label] = build.launch_counts()
        stats = engine.stats()
        print(f"svhn serve {label}: {json.dumps(stats)}", flush=True)
        print(f"svhn serve {label}: launches {served[label]}", flush=True)
        if len(done) != SVHN_REQUESTS or any(r.status != "ok"
                                             for r in done):
            raise AssertionError(f"svhn serve {label}: statuses "
                                 f"{[r.status for r in done]}")
        if served[label][sym] < 1:
            raise AssertionError(f"svhn serve {label}: {sym} never ran")
        same_predictions(f"svhn serve {label}", torch.tensor(np.stack(
            [r.lengths for r in sorted(done, key=lambda r: r.rid)])),
            plain_len, ROUTING[1])
    serve_counts = served["pipelined"]

    # Each new kernel against its twin, and K13/K13b against K4/K9, at the
    # path's shapes (activations from the plain path).
    cx1, u0 = conv_inputs(cfg, params, images)              # [8, 2048, 8]
    tcx1, tu0 = conv_inputs(cfg, params, timages)           # [16, 2048, 8]
    with torch.no_grad():
        h0 = capsnet.routing_by_agreement(capsnet.compute_votes(
            u0, params[lay0.param]), lay0.iters)            # [8, 64, 8]
    i1 = half.num_caps
    x1, x2 = h0[:, :i1].contiguous(), h0[:, i1:].contiguous()
    r1 = x1.reshape(SLOTS, -1)
    g0 = randn(tb, lay0.jd, scale=1e-2)
    u, wcc, tu, g = mnist["u"], mnist["wcc"], mnist["tu"], mnist["g"]
    mvr, mst = mnist["vr"], mnist["mst"]
    mb_i = 128                    # K13's i-tile at MNIST width
    kw0 = dict(iters=lay0.iters, num_classes=lay0.num_caps)
    kwh = dict(iters=half.iters, num_classes=half.num_caps)
    kwm = dict(iters=3, num_classes=10)
    errs: dict[str, float] = {}

    def held(kernel, name, got, want, tol):
        errs[kernel] = max(errs.get(kernel, 0.0),
                           check(name, got, want, tol)["max_abs"])

    def held_bwd(kernel, name, got, want):
        errs[kernel] = max(errs.get(kernel, 0.0), *(
            check_scaled(f"{name} {part}", x, y, GRAD)
            for part, x, y in zip(("du", "dW"), got, want)))

    kwf = dict(iters=final.iters, num_classes=final.num_caps)
    k4_rows = {"streamed": "votes_routing_streamed_cluster",
               GLOBAL: "votes_routing_global_cluster"}
    with torch.no_grad():
        for mode in ("streamed", GLOBAL):
            kw4 = dict(mode=mode, block_i=12, **kwh)
            cs4 = k34.fwd_cluster(x2, wf, cluster=None, **kw4)
            held(k4_rows[mode], f"K4 residual epilogue, {mode}, SVHN "
                 f"half {half.in_caps}->{half.num_caps}x{half.caps_dim}, "
                 f"{cs4}-CTA clusters",
                 k34.votes_routing(x2, wf, r=r1, **kw4),
                 k34.cluster_routing_plain(x2, wf, r=r1, cluster=cs4,
                                           **kw4), ROUTING)
        # K3 on the plan's clusters: a half with the residual epilogue and
        # ClassCaps, each twice for identical bits.
        for label, uu, ww, rr, op, kw in (
                (f"SVHN half {half.in_caps}->{half.num_caps}x"
                 f"{half.caps_dim} + residual", x2, wf, r1, hop, kwh),
                (f"SVHN ClassCaps {final.in_caps}->{final.num_caps}x"
                 f"{final.caps_dim}", h0, wfin, None, fop, kwf)):
            print(f"K3 {label}, batch {SLOTS}: clusters of {op.cluster} "
                  f"({op.block.ctas} CTAs), {op.smem_bytes} B a CTA",
                  flush=True)
            held("votes_routing_cluster", f"K3 {label}, {op.cluster}-CTA "
                 f"clusters", same_bits(f"K3 {label}", lambda: (
                     k34.votes_routing(uu, ww, r=rr, mode=op.mode,
                                       block_i=op.block_i,
                                       cluster=op.cluster, **kw))),
                 k3_twin(uu, ww, rr, op.cluster, **kw), ROUTING)
        # K4 at the bottleneck on the per-op plan's cluster, and with
        # streamed-global named (on the planner's size for it), each twice
        # for identical bits.
        kwn = dict(mode=neck.mode, block_i=neck.block_i, **kw0)
        print(f"K4 SVHN bottleneck batch {SLOTS}: {neck.mode} votes, "
              f"block_i {neck.block_i}, clusters of {neck.cluster} "
              f"({neck.block.ctas} CTAs), {neck.smem_bytes} B a CTA",
              flush=True)
        v_neck = same_bits("K4 SVHN bottleneck", lambda: k34.votes_routing(
            u0, w0, cluster=neck.cluster, **kwn))
        held("votes_routing_streamed_cluster", f"K4 streamed, SVHN "
             f"bottleneck, {neck.cluster}-CTA clusters", v_neck,
             k34.cluster_routing_plain(u0, w0, cluster=neck.cluster, **kwn),
             ROUTING)
        kwg = dict(kw0, mode=GLOBAL, block_i=neck.block_i)
        gcs = k34.fwd_cluster(u0, w0, cluster=None, **kwg)
        held("votes_routing_global_cluster", f"K4 streamed-global, SVHN "
             f"bottleneck, {gcs}-CTA clusters", same_bits(
                 "K4g SVHN bottleneck", lambda: k34.votes_routing(
                     u0, w0, cluster=gcs, **kwg)),
             k34.cluster_routing_plain(u0, w0, cluster=gcs, **kwg), ROUTING)
        # K5 on the pipelined plan's cluster, from the plain path's
        # patches, twice for identical bits.
        svp = conv_patches(cfg, params, images)
        wpc0 = params["pc_w"].reshape(-1, cfg.pc_channels)
        kw5 = dict(mode=spr.mode, block_i=spr.block_i, cluster=spr.cluster)
        print(f"K5 SVHN batch {SLOTS}: {spr.mode} votes, block_i "
              f"{spr.block_i}, clusters of {spr.cluster} ({spr.block.ctas} "
              f"CTAs), {spr.smem_bytes} B a CTA", flush=True)
        held("primary_routing", f"K5 primary_routing, SVHN batch {SLOTS}, "
             f"{spr.mode}, {spr.cluster}-CTA clusters",
             same_bits("K5 SVHN", lambda: k5.primary_routing_patches(
                 svp, wpc0, params["pc_b"], w0, **kw5, **kw0)),
             k5.primary_routing_patches_plain(svp, wpc0, params["pc_b"], w0,
                                              **kw5, **kw0), ROUTING)
    print(f"K9 SVHN bottleneck batch {tb}: {nbwd.mode} votes, block_i "
          f"{nbwd.block_i}, clusters of {nbwd.cluster} ({nbwd.block.ctas} "
          f"CTAs), {nbwd.smem_bytes} B a CTA", flush=True)
    kw9 = dict(mode=nbwd.mode, block_i=nbwd.block_i, cluster=nbwd.cluster)
    held_bwd("routing_bwd_cluster", f"K9 on the cluster, SVHN bottleneck "
             f"batch {tb}", same_bits("K9 SVHN", lambda: k34.votes_routing_bwd(
                 tu0, w0, g0, **kw9, **kw0)),
             k34.votes_routing_bwd_plain(tu0, w0, g0, **kw9, **kw0))
    # K8 (resident votes on the same cluster kernel) at a half's training
    # shape, twice for identical bits.
    gh = randn(tb, half.jd, scale=1e-2)
    tx2 = randn(tb, half.in_caps, half.in_dim, scale=0.1)
    kw8 = dict(mode=hbwd.mode, block_i=hbwd.block_i, cluster=hbwd.cluster)
    print(f"K8 SVHN half batch {tb}: clusters of {hbwd.cluster} "
          f"({hbwd.block.ctas} CTAs), {hbwd.smem_bytes} B a CTA", flush=True)
    held_bwd("routing_bwd_cluster", f"K8 on the cluster, SVHN half batch "
             f"{tb}", same_bits("K8 SVHN half", lambda: k34.votes_routing_bwd(
                 tx2, wf, gh, **kw8, **kwh)),
             k34.votes_routing_bwd_plain(tx2, wf, gh, **kw8, **kwh))
    # K13 against K4 and K13b against K9 on the same cluster and i-tile:
    # the same bits (the unfused schedule makes the fused pass's sums in
    # its order), twice each, and within ROUTING / GRAD of the twins.
    build.reset_launch_counts()
    with torch.no_grad():
        for label, uu, ww, bi, kw in (
                ("MNIST ClassCaps", u, wcc, mb_i, kwm),
                ("SVHN bottleneck", u0, w0, neck.block_i, kw0)):
            cs13 = k34.fwd_cluster(uu, ww, mode=ORACLE, cluster=None,
                                   block_i=bi, **kw)
            got = same_bits(f"K13 {label}", lambda: k34.votes_routing(
                uu, ww, mode=ORACLE, block_i=bi, **kw))
            held("votes_routing_2pass", f"K13 forward, {label}, {cs13}-CTA "
                 f"clusters", got, k34.cluster_routing_plain(
                     uu, ww, mode=ORACLE, block_i=bi, cluster=cs13, **kw),
                 ROUTING)
            equal_bits(f"K13 forward against K4, {label}, {cs13}-CTA "
                       f"clusters, block_i {bi}", got, k34.votes_routing(
                           uu, ww, mode="streamed", block_i=bi,
                           cluster=cs13, **kw))
    for label, uu, ww, gg, bi, kw in (
            ("MNIST ClassCaps", tu, wcc, g, 128, kwm),
            ("SVHN bottleneck", tu0, w0, g0, 64, kw0)):
        _, cs13 = k34.bwd_schedule(uu, ww, mode=ORACLE, cluster=None, **kw)
        got = same_bits(f"K13b {label}", lambda: k34.votes_routing_bwd(
            uu, ww, gg, mode=ORACLE, block_i=bi, **kw))
        held_bwd("routing_bwd_2pass", f"K13 backward, {label}, {cs13}-CTA "
                 f"clusters", got, k34.votes_routing_bwd_plain(
                     uu, ww, gg, mode=ORACLE, block_i=bi, cluster=cs13,
                     **kw))
        equal_bits(f"K13 backward (du, dW) against K9, {label}, {cs13}-CTA "
                   f"clusters, block_i {bi}", got, k34.votes_routing_bwd(
                       uu, ww, gg, mode="streamed", block_i=bi,
                       cluster=cs13, **kw))
    torch.cuda.synchronize()
    oracle_counts = build.launch_counts()

    # One training gradient through K12 against the plain backend: SVHN at
    # full width, then the CIFAR-10 smoke config (3 all-residual blocks).
    ccfg = capsnet_cifar10.smoke_config()
    cparams = capsnet.init_params(torch.Generator().manual_seed(SEED + 4),
                                  ccfg, device=dev)
    cimages = uniform(tb, ccfg.image_hw, ccfg.image_hw, ccfg.in_channels)
    grad_counts = {}
    for label, cfg_, params_, imgs_, plan_, k12_halves in (
            ("svhn", cfg, params, timages, tplan, 4),
            ("cifar10 smoke", ccfg, cparams, cimages,
             execplan.compile_plan(ccfg, batch=tb, pipeline=True,
                                   train=True), 6)):
        want, _ = capsnet.loss_and_grads(params_, imgs_, labels, cfg_,
                                         backend="torch", device=dev)
        build.reset_launch_counts()
        got, _ = capsnet.loss_and_grads(params_, imgs_, labels, cfg_,
                                        backend="kernels", plan=plan_,
                                        device=dev)
        torch.cuda.synchronize()
        grad_counts[label] = build.launch_counts()
        print(f"backward {label}: launches {grad_counts[label]}", flush=True)
        for k in params_:
            check_scaled(f"backward {label} d{k}", got[k], want[k], GRAD)
        # Each half runs K3 twice (forward, and the K12 backward's
        # recompute) and the cluster backward (K8) once, ClassCaps K3 and
        # K8 once each; SVHN's bottleneck adds K9 (the same kernel).
        want_bwd = k12_halves + 1 + (label == "svhn")
        if grad_counts[label]["votes_routing_cluster_f32"] != \
                2 * k12_halves + 1 or \
                grad_counts[label]["routing_bwd_cluster_f32"] != want_bwd:
            raise AssertionError(f"backward {label}: K3 and K8/K9 did not "
                                 f"run {2 * k12_halves + 1} and {want_bwd} "
                                 f"times")
    if grad_counts["svhn"]["primary_routing_f32"] != 1:
        raise AssertionError("backward svhn: K5 did not run once")

    # The SVHN smoke config's pipelined plan: K5 (J = 16) leads the stack.
    scfg = capsnet_svhn.smoke_config()
    sparams = capsnet.init_params(torch.Generator().manual_seed(SEED + 5),
                                  scfg, device=dev)
    simages = uniform(SLOTS, scfg.image_hw, scfg.image_hw, scfg.in_channels)
    splan = execplan.compile_plan(scfg, batch=SLOTS, pipeline=True)
    print(f"plan SVHN smoke pipelined: {json.dumps(splan.summary())}",
          flush=True)
    with torch.no_grad():
        build.reset_launch_counts()
        sout = capsnet.forward(sparams, simages, scfg, backend="kernels",
                               plan=splan, device=dev)
        torch.cuda.synchronize()
        pipe_counts = build.launch_counts()
        sref = capsnet.forward(sparams, simages, scfg, backend="torch",
                               device=dev)
    for key in ("class_caps", "lengths", "reconstruction"):
        check(f"svhn smoke pipelined {key}", sout[key], sref[key], ROUTING)
    if pipe_counts["primary_routing_f32"] != 1 or \
            pipe_counts["votes_routing_cluster_f32"] < 5:
        raise AssertionError(f"svhn smoke pipelined: launches {pipe_counts}")

    # Train the full-width network: SGD (the loop's default), reported,
    # then AdamW, whose loss must fall.  At this init the class capsules'
    # lengths are ~1e-4 and the margin loss's gradient through them
    # vanishes, so plain SGD barely moves the loss; AdamW rescales each
    # parameter's step.
    # Both plans: SGD and AdamW on the pipelined plan, AdamW on the per-op
    # plan; under AdamW the loss must fall.
    step_ms, counts_by = {}, {}
    for opt, lr, pipe in (("sgd", 3e-2, True), ("adam", 3e-3, True),
                          ("adam", 3e-3, False)):
        with tempfile.TemporaryDirectory() as tmp:
            loop = capsnet_loop.CapsTrainLoop(
                cfg, capsnet_loop.CapsLoopConfig(
                    total_steps=TRAIN_STEPS, batch=tb, lr=lr, optimizer=opt,
                    ckpt_every=10, ckpt_dir=tmp, log_every=5, seed=SEED),
                device=dev)
            if not pipe:
                loop.plan = execplan.compile_plan(cfg, batch=tb, train=True,
                                                  pipeline=False)
            build.reset_launch_counts()
            hist = loop.run(resume=False)
            torch.cuda.synchronize()
            train_counts = build.launch_counts()
        key = f"{opt} {'pipelined' if pipe else 'per-op'}"
        step_ms[key] = 1e3 * statistics.median(h["time_s"] for h in hist)
        counts_by[key] = train_counts
        ok = len(hist) == TRAIN_STEPS and capsnet_loop.improved(
            hist, loop.nan_skips)
        print(f"train svhn {key} lr {lr:g}: {TRAIN_STEPS} steps at batch "
              f"{tb}, loss {[round(h['loss'], 4) for h in hist]}, means of "
              f"the first and last 3 {capsnet_loop.loss_ends(hist)}, "
              f"improved {ok}, median step {step_ms[key]:.2f} ms, launches "
              f"{train_counts}", flush=True)
        if opt == "adam" and not ok:
            raise AssertionError(f"train svhn {key}: the loss did not fall "
                                 f"under AdamW, or a rollback fired")
    train_counts = counts_by["sgd pipelined"]
    for key, syms in (("sgd pipelined", ("primary_routing_f32",
                                         "routing_bwd_cluster_f32",
                                         "votes_routing_cluster_f32")),
                      ("adam per-op", ("votes_routing_streamed_cluster_f32",
                                       "routing_bwd_cluster_f32",
                                       "votes_routing_cluster_f32"))):
        for sym in syms:
            if counts_by[key][sym] < TRAIN_STEPS:
                raise AssertionError(f"train svhn {key}: {sym} ran "
                                     f"{counts_by[key][sym]} times")
    # A step: K3 9 times (4 halves forward and recomputed, ClassCaps), the
    # cluster backward 6 (K8 at the 4 halves and ClassCaps, K9 at the
    # bottleneck); serving 16 requests at 8 slots: 2 forwards of 5 K3.
    for what, got, want in (
            ("K3 in the 20-step run",
             train_counts["votes_routing_cluster_f32"], 9 * TRAIN_STEPS),
            ("K8 + K9 in the 20-step run",
             train_counts["routing_bwd_cluster_f32"], 6 * TRAIN_STEPS),
            ("K3 in the 16-request run",
             serve_counts["votes_routing_cluster_f32"],
             5 * -(-SVHN_REQUESTS // SLOTS))):
        print(f"svhn launches: {what}: {got} (at least {want})", flush=True)
        if got < want:
            raise AssertionError(f"svhn: {what}: {got} launches, fewer "
                                 f"than {want}")
    # The oracle runs on no main path.
    for what, counts in (("the 16-request run", serve_counts),
                         ("the 20-step run", train_counts)):
        for sym in ("votes_routing_2pass_f32", "routing_bwd_2pass_f32"):
            if counts[sym]:
                raise AssertionError(f"svhn: {what} launched the oracle "
                                     f"{sym} {counts[sym]} times")

    # Times: the forward and the K12 segment, then each new kernel against
    # its twin and its bound (K13 also against the fused kernel).
    with torch.no_grad():
        fwd_ms = {label: time_ms(lambda b=b, p=p: capsnet.forward(
            params, images, cfg, backend=b, plan=p, device=dev))
            for label, b, p in (("kernels, pipelined plan", "kernels", plan),
                                ("kernels, per-op plan", "kernels", pplan),
                                ("torch", "torch", None))}
    pairs = tuple((stack[k], stack[k + 1]) for k in (1, 3))
    seg_ws = tuple(w_of(lyr) for pair in pairs for lyr in pair)
    h_seg = h0.detach().clone()
    th_seg = randn(tb, *h0.shape[1:], scale=0.1)

    def seg_fwd():
        return ops.res_caps_segment(h_seg, seg_ws, pairs, plan=plan)

    def seg_fwd_bwd():
        x = th_seg.detach().requires_grad_()
        ws_ = [w.detach().requires_grad_() for w in seg_ws]
        ops.res_caps_segment(x, ws_, pairs, plan=tplan).sum().backward()
        return x.grad

    def seg_plain(h, pw):
        """K12's function in plain PyTorch (``routing_stack_ref``'s
        coupling), autograd for its backward."""
        for lf, lg in pairs:
            x1, x2 = h[:, :lf.num_caps], h[:, lf.num_caps:]
            y1 = x1 + capsnet.routing_by_agreement(
                capsnet.compute_votes(x2, pw[lf.param]), lf.iters)
            y2 = x2 + capsnet.routing_by_agreement(
                capsnet.compute_votes(y1, pw[lg.param]), lg.iters)
            h = torch.cat([y1, y2], dim=1)
        return h

    def seg_plain_fwd_bwd():
        x = th_seg.detach().requires_grad_()
        pw = {lyr.param: params[lyr.param].detach().requires_grad_()
              for pair in pairs for lyr in pair}
        seg_plain(x, pw).sum().backward()
        return x.grad

    def seg_bound(b: int, backward: bool) -> float:
        """K12's bound: the sum of its kernels' bounds at the segment's
        shapes (each half's forward, and with ``backward`` its backward;
        the backward's recompute is the schedule's cost, not the
        function's)."""
        total = 0.0
        for lyr in (lyr for pair in pairs for lyr in pair):
            u_n = b * lyr.in_caps * lyr.in_dim
            w_n = lyr.in_caps * lyr.jd * lyr.in_dim
            args = (b, lyr.in_caps, lyr.in_dim, lyr.jd, lyr.iters)
            total += bound(4.0 * (u_n + w_n + 2 * b * lyr.jd),
                           routing_flops(*args))[0]
            if backward:
                total += bound(4.0 * (2 * (u_n + w_n) + b * lyr.jd),
                               routing_bwd_flops(*args))[0]
        return total

    with torch.no_grad():
        seg = dict(fwd_ms=time_ms(seg_fwd), fwd_device_ms=device_ms(seg_fwd),
                   plain_fwd_ms=time_ms(lambda: seg_plain(h_seg, params)))
    seg.update(fwd_bwd_ms=time_ms(seg_fwd_bwd),
               fwd_bwd_device_ms=device_ms(seg_fwd_bwd),
               plain_fwd_bwd_ms=time_ms(seg_plain_fwd_bwd),
               fwd_bound_ms=seg_bound(SLOTS, False),
               fwd_bwd_bound_ms=seg_bound(tb, True))
    print(f"svhn forward ms at batch {SLOTS}: {json.dumps(fwd_ms)}; "
          f"train step median ms at batch {tb}: {json.dumps(step_ms)}; K12 "
          f"segment (2 blocks): {json.dumps(seg)}", flush=True)
    # Where the device time goes: one forward at the engine's batch on
    # each plan, one training gradient at the trainer's batch.
    with torch.no_grad():
        for label, p in (("pipelined", plan), ("per-op", pplan)):
            fwd_split = device_breakdown(lambda p=p: capsnet.forward(
                params, images, cfg, backend="kernels", plan=p, device=dev))
            print(f"svhn forward {label} device ms by kernel (batch "
                  f"{SLOTS}): {json.dumps(fwd_split)}", flush=True)
    step_split = device_breakdown(lambda: capsnet.loss_and_grads(
        params, timages, labels, cfg, backend="kernels", plan=tplan,
        device=dev))
    print(f"svhn gradient device ms by kernel (batch {tb}): "
          f"{json.dumps(step_split)}", flush=True)
    svhn_gather_sites(cfg, rows, images, timages, cx1, tcx1, randn,
                      serve_counts, train_counts)
    neck_bytes = 4.0 * (u0.numel() + w0.numel() + SLOTS * lay0.jd)
    neck_flops = routing_flops(SLOTS, lay0.in_caps, lay0.in_dim, lay0.jd, 3)
    mn = dict(bytes=4.0 * (u.numel() + wcc.numel() + SLOTS * wcc.shape[1]),
              flops=routing_flops(SLOTS, u.shape[1], u.shape[2],
                                  wcc.shape[1], 3))
    # K13 and K13b on their clusters (K4's and K9's at the site's batch and
    # i-tile), each site beside the fused kernel on the same cluster and
    # i-tile and an empty launch of its grid (K13b: of the replay's grid,
    # its replay and emit apart).
    def oracle_site(op, bsz, uu, ww, gg, bi, kw, nbytes, flops):
        i_dim, c_dim, j, jd = (uu.shape[1], uu.shape[2], kw["num_classes"],
                               ww.shape[1])
        if gg is None:
            cs13 = k34.fwd_cluster(uu, ww, mode=ORACLE, cluster=None,
                                   block_i=bi, **kw)
            place = k34.logits_placement(ORACLE, i_dim, c_dim, j, jd, cs13,
                                         bi)
            smem = execplan.votes_routing_cluster_smem(
                i_dim, c_dim, j, jd, cs13, mode=place, block_i=bi)

            def run(mode):
                return k34.votes_routing(uu, ww, mode=mode, block_i=bi,
                                         cluster=cs13, **kw)

            def plain():
                return k34.cluster_routing_plain(uu, ww, mode=ORACLE,
                                                 block_i=bi, cluster=cs13,
                                                 **kw)
        else:
            _, cs13 = k34.bwd_schedule(uu, ww, mode=ORACLE, cluster=None,
                                       **kw)
            place = "streamed"
            smem = execplan.routing_bwd_cluster_smem(
                "streamed", i_dim, bi, c_dim, j, jd, cs13)

            def run(mode):
                return k34.votes_routing_bwd(uu, ww, gg, mode=mode,
                                             block_i=bi, cluster=cs13, **kw)

            def plain():
                return k34.votes_routing_bwd_plain(uu, ww, gg, mode=ORACLE,
                                                   block_i=bi, cluster=cs13,
                                                   **kw)
        site = timed_sites([(op, lambda: run(ORACLE), plain, None, nbytes,
                             flops)])[0]
        site.update(cluster=cs13, ctas=bsz * cs13, block_i=bi, logits=place,
                    smem_bytes=smem,
                    fused_device_ms=device_ms(lambda: run("streamed")),
                    empty_launch=empty_floor(bsz, cs13, smem))
        if gg is not None:
            site.update(replay_emit_ms(lambda: run(ORACLE)))
        print(f"K13 {op}: clusters of {cs13} ({bsz * cs13} CTAs), block_i "
              f"{bi}, logits {place}, {smem} B a CTA: device "
              f"{site['device_ms']} ms, the fused kernel on the same "
              f"cluster {site['fused_device_ms']} ms, bound "
              f"{site['bound_ms']:.6f} ms ({site['bound_by']}), empty launch "
              f"{json.dumps(site['empty_launch'])}; on {CARD}", flush=True)
        return site

    with torch.no_grad():
        oracle_rows = (
            ("votes_routing_2pass", "votes_routing.cu",
             "src/repro/kernels/votes_routing.py:189",
             "oracle only: 0 launches on the SVHN serving path",
             serve_counts, [
                 oracle_site("ClassCaps-Routing (MNIST, 8)", SLOTS, u, wcc,
                             None, mb_i, kwm, mn["bytes"], mn["flops"]),
                 oracle_site(lay0.name + " (SVHN, 8)", SLOTS, u0, w0, None,
                             neck.block_i, kw0, neck_bytes, neck_flops)]),
            ("routing_bwd_2pass", "votes_routing_bwd.cu",
             "src/repro/kernels/votes_routing.py:426",
             "oracle only: 0 launches on the SVHN training path",
             train_counts, [
                 oracle_site("ClassCaps-Routing-bwd (MNIST, 16)", tb, tu,
                             wcc, g, 128, kwm, routing_bwd_bytes(tu, wcc),
                             routing_bwd_flops(tb, tu.shape[1], tu.shape[2],
                                               wcc.shape[1], 3)),
                 oracle_site(lay0.name + "-bwd (SVHN, 16)", tb, tu0, w0, g0,
                             64, kw0, routing_bwd_bytes(tu0, w0),
                             routing_bwd_flops(tb, lay0.in_caps, lay0.in_dim,
                                               lay0.jd, 3))]))
        for kernel, source, replaces, path, counts, site_rows in oracle_rows:
            main = site_rows[0]
            rows.append(dict(
                name=kernel, route="cuda",
                source=f"src/repro_torch/kernels/csrc/{source}",
                replaces=replaces, launches=counts[f"{kernel}_f32"],
                oracle_launches=oracle_counts[f"{kernel}_f32"],
                max_abs_err=errs[kernel], ms=main["ms"],
                device_ms=main["device_ms"], plain_ms=main["plain_ms"],
                bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                library_ms=None, path=path, cluster=main["cluster"],
                ctas=main["ctas"], fused_device_ms=main["fused_device_ms"],
                sites=site_rows))
        # K4 on its clusters: the per-op plan's bottleneck (the row's main
        # site), MNIST with streamed votes named and the smoke config's
        # ragged tile; K4g (streamed-global named) at the bottleneck; each
        # beside an empty launch of its grid.
        by_name = {r["name"]: r for r in rows}
        su, swcc, svr = mnist["su"], mnist["swcc"], mnist["svr"]
        mn_bytes = 4.0 * (u.numel() + wcc.numel() + SLOTS * wcc.shape[1])
        k4_sites = {"votes_routing_streamed_cluster": [],
                    "votes_routing_global_cluster": []}
        for kernel, op_name, uu, ww, kw, nbytes in (
                (k4_rows["streamed"], lay0.name + " (SVHN bottleneck, 8)",
                 u0, w0, kwn, neck_bytes),
                (k4_rows["streamed"], execplan.FUSED_NAME
                 + " (MNIST, streamed named, 8)", u, wcc,
                 dict(kwm, mode="streamed", block_i=mst.block_i),
                 mn_bytes),
                (k4_rows["streamed"], execplan.FUSED_NAME
                 + " (MNIST smoke, streamed, block_i 24, 8)", su, swcc,
                 dict(kwm, mode="streamed", block_i=24),
                 4.0 * (su.numel() + swcc.numel()
                        + SLOTS * swcc.shape[1])),
                (k4_rows[GLOBAL], lay0.name
                 + " (SVHN bottleneck, streamed-global named, 8)", u0, w0,
                 kwg, neck_bytes)):
            cs4 = k34.fwd_cluster(uu, ww, cluster=None, **kw)
            smem4 = execplan.votes_routing_cluster_smem(
                uu.shape[1], uu.shape[2], kw["num_classes"], ww.shape[1],
                cs4, mode=kw["mode"], block_i=kw["block_i"])
            site = timed_sites([(
                op_name,
                lambda uu=uu, ww=ww, kw=kw, cs4=cs4: k34.votes_routing(
                    uu, ww, cluster=cs4, **kw),
                lambda uu=uu, ww=ww, kw=kw, cs4=cs4:
                    k34.cluster_routing_plain(uu, ww, cluster=cs4, **kw),
                None, nbytes,
                routing_flops(SLOTS, uu.shape[1], uu.shape[2], ww.shape[1],
                              kw["iters"]))])[0]
            site.update(cluster=cs4, ctas=SLOTS * cs4, mode=kw["mode"],
                        block_i=kw["block_i"], smem_bytes=smem4,
                        empty_launch=empty_floor(SLOTS, cs4, smem4))
            print(f"K4 {op_name}: {kw['mode']} votes, block_i "
                  f"{kw['block_i']}, clusters of {cs4}, device "
                  f"{site['device_ms']} ms, bound {site['bound_ms']:.6f} ms "
                  f"({site['bound_by']}), empty launch "
                  f"{json.dumps(site['empty_launch'])}", flush=True)
            k4_sites[kernel].append(site)
        for kernel, path, counts in (
                (k4_rows["streamed"], "serve, SVHN full width, per-op plan "
                 "(the bottleneck)", served["per-op"]),
                (k4_rows[GLOBAL], "no main path (CIFAR-10's full-width "
                 "halves plan it; not run at full width here): the SVHN "
                 "bottleneck with streamed-global named", served["per-op"])):
            main = k4_sites[kernel][0]
            row = dict(
                name=kernel, route="cuda",
                source="src/repro_torch/kernels/csrc/votes_routing.cu",
                replaces="src/repro/kernels/votes_routing.py:139",
                launches=counts[f"{kernel}_f32"],
                max_abs_err=max(errs[kernel], mnist["k4_err"]
                                if kernel == k4_rows["streamed"] else 0.0),
                ms=main["ms"], device_ms=main["device_ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=None, path=path,
                cluster=main["cluster"], ctas=main["ctas"],
                sites=k4_sites[kernel])
            rows.append(row)
            by_name[kernel] = row
        # Every cluster size at the bottleneck: streamed-global below 4
        # CTAs, streamed from 4 up.
        k4_row = by_name[k4_rows["streamed"]]
        k4_row["cluster_sweep"] = {"SVHN bottleneck, 8": cluster_sweep(
            f"K4 SVHN bottleneck batch {SLOTS}",
            lambda cs: execplan.plan_votes_routing_cluster(
                lay0.in_caps, lay0.in_dim, lay0.jd, lay0.num_caps,
                iters=lay0.iters, batch=SLOTS, cluster=cs),
            lambda sc, cs: k34.votes_routing(
                u0, w0, mode=sc.mode, block_i=sc.block_i, cluster=cs,
                **kw0),
            lambda sc, cs: k34.cluster_occupancy(
                lay0.in_caps, lay0.in_dim, lay0.num_caps, lay0.caps_dim,
                cluster=cs, mode=sc.mode, block_i=sc.block_i))}
        k4_row["planned_over_best"] = sweep_miss(
            f"K4 SVHN bottleneck batch {SLOTS}",
            k4_row["cluster_sweep"]["SVHN bottleneck, 8"], neck.cluster)
        # K3 on its clusters: a half with the residual epilogue (the row's
        # main site), ClassCaps, the MNIST per-op ClassCaps and the MNIST
        # smoke config, each beside an empty launch of its grid; every
        # cluster size at the SVHN shapes and at MNIST.
        k3_sites = []
        for op_name, uu, ww, rr, op, kw in (
                (half.name + " (SVHN half + residual, 8)", x2, wf, r1, hop,
                 kwh),
                (final.name + " (SVHN ClassCaps, 8)", h0, wfin, None, fop,
                 kwf),
                (execplan.FUSED_NAME + " (MNIST per-op, 8)", u, wcc, None,
                 mvr, dict(iters=3, num_classes=10)),
                (execplan.FUSED_NAME + " (MNIST smoke, 8)", su, swcc, None,
                 svr, dict(iters=3, num_classes=10))):
            site = timed_sites([(
                op_name,
                lambda uu=uu, ww=ww, rr=rr, op=op, kw=kw: k34.votes_routing(
                    uu, ww, r=rr, mode=op.mode, block_i=op.block_i,
                    cluster=op.cluster, **kw),
                lambda uu=uu, ww=ww, rr=rr, op=op, kw=kw: k3_twin(
                    uu, ww, rr, op.cluster, **kw), None,
                4.0 * (uu.numel() + ww.numel()
                       + (1 if rr is None else 2) * SLOTS * ww.shape[1]),
                routing_flops(SLOTS, uu.shape[1], uu.shape[2], ww.shape[1],
                              kw["iters"]))])[0]
            site.update(cluster=op.cluster, ctas=op.block.ctas,
                        empty_launch=empty_floor(SLOTS, op.cluster,
                                                 op.smem_bytes))
            print(f"K3 {op_name}: clusters of {op.cluster}, device "
                  f"{site['device_ms']} ms, bound {site['bound_ms']:.6f} ms "
                  f"({site['bound_by']}), empty launch "
                  f"{json.dumps(site['empty_launch'])}", flush=True)
            k3_sites.append(site)
        main = k3_sites[0]
        k3_row = dict(
            name="votes_routing_cluster", route="cuda",
            source="src/repro_torch/kernels/csrc/votes_routing.cu",
            replaces="src/repro/kernels/votes_routing.py:119",
            launches=serve_counts["votes_routing_cluster_f32"],
            max_abs_err=max(errs["votes_routing_cluster"], mnist["k3_err"]),
            ms=main["ms"], device_ms=main["device_ms"],
            plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
            bound_by=main["bound_by"], library_ms=None,
            path="serve, SVHN full width, pipelined plan (the ResCaps "
                 "halves with the residual epilogue, and ClassCaps)",
            sites=k3_sites, cluster_sweep={})
        rows.append(k3_row)
        by_name[k3_row["name"]] = k3_row
        for label, uu, ww, rr, lay, kw, planned in (
                ("SVHN half + residual, 8", x2, wf, r1, half, kwh,
                 hop.cluster),
                ("SVHN ClassCaps, 8", h0, wfin, None, final, kwf,
                 fop.cluster),
                ("MNIST per-op, 8", u, wcc, None, mnist["lay"], kwm,
                 mvr.cluster)):
            k3_row["cluster_sweep"][label] = cluster_sweep(
                f"K3 {label}",
                lambda cs, lay=lay: execplan.plan_votes_routing_cluster(
                    lay.in_caps, lay.in_dim, lay.jd, lay.num_caps,
                    iters=lay.iters, batch=SLOTS, cluster=cs,
                    votes="resident"),
                lambda sc, cs, uu=uu, ww=ww, rr=rr, kw=kw: k34.votes_routing(
                    uu, ww, r=rr, mode=sc.mode, block_i=sc.block_i,
                    cluster=cs, **kw),
                lambda sc, cs, lay=lay: k34.cluster_occupancy(
                    lay.in_caps, lay.in_dim, lay.num_caps, lay.caps_dim,
                    cluster=cs))
            sweep_miss(f"K3 {label}", k3_row["cluster_sweep"][label],
                       planned)
        # K5 and K9 at the SVHN bottleneck, as sites of their rows, with
        # every cluster size.
        k5_row = by_name["primary_routing"]
        svn = cfg.pc_channels
        k5_row["sites"] += timed_sites([
            (execplan.PIPE_NAME + " (SVHN, 8)",
             lambda: k5.primary_routing_patches(svp, wpc0, params["pc_b"],
                                                w0, **kw5, **kw0),
             lambda: k5.primary_routing_patches_plain(
                 svp, wpc0, params["pc_b"], w0, **kw5, **kw0), None,
             4.0 * (svp.numel() + wpc0.numel() + svn + w0.numel()
                    + SLOTS * lay0.jd),
             2.0 * svp.shape[0] * svp.shape[1] * svp.shape[2] * svn
             + neck_flops)])
        k5_row["sites"][-1].update(cluster=spr.cluster, ctas=spr.block.ctas,
                                   mode=spr.mode)

        def k5_plan_at(cs):
            try:
                return execplan.plan_primary_routing(
                    svp.shape[1], svp.shape[2], svn, lay0.in_caps,
                    lay0.in_dim, lay0.jd, lay0.num_caps, batch=SLOTS,
                    cluster=cs)
            except execplan.PlanError:
                return None

        k5_row["cluster_sweep"]["SVHN, 8"] = cluster_sweep(
            f"K5 SVHN batch {SLOTS}", k5_plan_at,
            lambda sc, cs: k5.primary_routing_patches(
                svp, wpc0, params["pc_b"], w0, mode=sc.mode,
                block_i=sc.block_i, cluster=cs, **kw0),
            lambda sc, cs: k5.occupancy(
                svp.shape[1], svn, cfg.primary_dim, lay0.num_caps,
                lay0.caps_dim, mode=sc.mode, block_i=sc.block_i,
                cluster=cs))
        sweep_miss(f"K5 SVHN batch {SLOTS}",
                   k5_row["cluster_sweep"]["SVHN, 8"], spr.cluster)
    k9_row = by_name["routing_bwd_cluster"]
    k9_row["sites"] += timed_sites([
        (lay0.name + "-bwd (SVHN, 16)",
         lambda: k34.votes_routing_bwd(tu0, w0, g0, **kw9, **kw0),
         lambda: k34.votes_routing_bwd_plain(tu0, w0, g0, **kw9, **kw0),
         None, routing_bwd_bytes(tu0, w0),
         routing_bwd_flops(tb, lay0.in_caps, lay0.in_dim, lay0.jd, 3))])
    k9_row["sites"][-1].update(
        cluster=nbwd.cluster, ctas=nbwd.block.ctas, mode=nbwd.mode,
        **replay_emit_ms(lambda: k34.votes_routing_bwd(tu0, w0, g0, **kw9,
                                                       **kw0)))
    print(f"K9 SVHN batch {tb}: replay "
          f"{k9_row['sites'][-1]['replay_device_ms']} ms, emit "
          f"{k9_row['sites'][-1]['emit_device_ms']} ms (device)", flush=True)
    # K8 (resident votes, the same cluster kernel) at a half's training
    # shape: a site of the row with its replay and emit apart, the floors
    # of empty launches of both grids, and every cluster size.
    k9_row["sites"] += timed_sites([
        (half.name + f"-bwd (K8, SVHN half, {tb})",
         lambda: k34.votes_routing_bwd(tx2, wf, gh, **kw8, **kwh),
         lambda: k34.votes_routing_bwd_plain(tx2, wf, gh, **kw8, **kwh),
         None, routing_bwd_bytes(tx2, wf),
         routing_bwd_flops(tb, half.in_caps, half.in_dim, half.jd, 3))])
    k8_site = k9_row["sites"][-1]
    k8_site.update(
        cluster=hbwd.cluster, ctas=hbwd.block.ctas, mode=hbwd.mode,
        **replay_emit_ms(lambda: k34.votes_routing_bwd(tx2, wf, gh, **kw8,
                                                       **kwh)),
        empty_launch=empty_floor(tb, hbwd.cluster,
                                 execplan.routing_bwd_cluster_smem(
                                     hbwd.mode, half.in_caps, hbwd.block_i,
                                     half.in_dim, half.num_caps, half.jd,
                                     hbwd.cluster)),
        empty_emit_launch=empty_floor(half.in_caps, 1,
                                      execplan.routing_bwd_emit_smem(
                                          half.in_dim, half.num_caps,
                                          half.jd)))
    print(f"K8 SVHN half batch {tb}: clusters of {hbwd.cluster}, device "
          f"{k8_site['device_ms']} ms: replay {k8_site['replay_device_ms']} "
          f"ms, emit {k8_site['emit_device_ms']} ms (device), bound "
          f"{k8_site['bound_ms']:.6f} ms; empty launches: replay grid "
          f"{json.dumps(k8_site['empty_launch'])}, emit grid "
          f"{json.dumps(k8_site['empty_emit_launch'])}", flush=True)
    k9_row["cluster_sweep"][f"K8 SVHN half, {tb}"] = cluster_sweep(
        f"K8 SVHN half batch {tb}",
        lambda cs: execplan.plan_routing_bwd_cluster(
            half.in_caps, half.in_dim, half.jd, half.num_caps, batch=tb,
            cluster=cs, votes="resident"),
        lambda sc, cs: k34.votes_routing_bwd(
            tx2, wf, gh, mode=sc.mode, block_i=sc.block_i, cluster=cs,
            **kwh),
        lambda sc, cs: k34.bwd_cluster_occupancy(
            half.in_caps, half.in_dim, half.num_caps, half.caps_dim,
            mode=sc.mode, block_i=sc.block_i, cluster=cs))
    sweep_miss(f"K8 SVHN half batch {tb}",
               k9_row["cluster_sweep"][f"K8 SVHN half, {tb}"], hbwd.cluster)
    k9_row["max_abs_err"] = max(k9_row["max_abs_err"],
                                errs["routing_bwd_cluster"])
    by_name["primary_routing"]["max_abs_err"] = max(
        by_name["primary_routing"]["max_abs_err"], errs["primary_routing"])
    k9_row["cluster_sweep"]["SVHN, 16"] = cluster_sweep(
        f"K9 SVHN bottleneck batch {tb}",
        lambda cs: execplan.plan_routing_bwd_cluster(
            lay0.in_caps, lay0.in_dim, lay0.jd, lay0.num_caps, batch=tb,
            cluster=cs),
        lambda sc, cs: k34.votes_routing_bwd(
            tu0, w0, g0, mode=sc.mode, block_i=sc.block_i, cluster=cs,
            **kw0),
        lambda sc, cs: k34.bwd_cluster_occupancy(
            lay0.in_caps, lay0.in_dim, lay0.num_caps, lay0.caps_dim,
            mode=sc.mode, block_i=sc.block_i, cluster=cs))
    sweep_miss(f"K9 SVHN bottleneck batch {tb}",
               k9_row["cluster_sweep"]["SVHN, 16"], nbwd.cluster)
    for row in rows:
        sym = row["name"] + "_f32"
        row["launches_svhn"] = dict(
            serve=serve_counts.get(sym, 0),
            serve_per_op=served["per-op"].get(sym, 0),
            train=train_counts.get(sym, 0))


def svhn_gather_sites(cfg, rows, images, timages, x1, tx1, randn,
                      serve_counts, train_counts) -> None:
    """K1 at capsnet-svhn's Conv1 and PrimaryCaps, at the engine's batch
    (``images``, Conv1 output ``x1``) and the trainer's (``timages``,
    ``tx1``), and K7 at its PrimaryCaps dx at the trainer's batch: each
    twice for identical bits and against its twin, then timed warm and
    cold beside its library call.  Sites of the K1 and K7 rows, outside
    their MNIST totals."""
    import torch.nn.functional as F

    from repro_torch.kernels import conv_im2col as k12
    k1c, kp, st = cfg.conv1_kernel, cfg.pc_kernel, cfg.pc_stride
    sites = [k1_site(f"{label} (SVHN, {xx.shape[0]})", "svhn", xx, k, s_)
             for imgs, xx1 in ((images, x1), (timages, tx1))
             for label, xx, k, s_ in (("Conv1", imgs, k1c, 1),
                                      ("PrimaryCaps", xx1, kp, st))]
    for op, _, fn, plain, *_ in sites:
        check(f"K1 im2col {op}", same_bits(f"K1 {op}", fn), plain(), EXACT)
    k1_row = next(r for r in rows if r["name"] == "im2col_patches")
    for site, row in zip(sites, timed_sites([(op, *rest[:5]) for op, _, *rest
                                             in sites])):
        row.update(path="svhn", **site[7](row))
        k1_row["sites"].append(row)
    bsz, hw = tx1.shape[0], cfg.conv1_out
    dp = randn(bsz, cfg.pc_out ** 2, kp * kp * cfg.conv1_channels,
               scale=1e-3)
    col_kw = dict(kh=kp, kw=kp, stride=st, h=hw, w=hw)
    op = f"PrimaryCaps-bwd (SVHN, {bsz})"

    def fn():
        return k12.col2im_patches(dp, **col_kw)
    fin = fold_input(dp, kp, kp)

    def lib():
        return F.fold(fin, output_size=(hw, hw), kernel_size=kp, stride=st)
    check(f"K7 col2im {op}", same_bits(f"K7 {op}", fn),
          k12.col2im_patches_plain(dp, **col_kw), EXACT)
    row = timed_sites([(op, fn, lambda: k12.col2im_patches_plain(
        dp, **col_kw), lib, 4.0 * (dp.numel() + tx1.numel()),
        float(dp.numel()))])[0]
    row.update(path="svhn", **gather_extras(row, fn, lib, "col2im_kernel"))
    next(r for r in rows if r["name"] == "col2im_patches")["sites"].append(
        row)
    # Launches: K1 runs at each site once a forward, and again in a
    # training step's backward (the patches recomputed for dW); K7 once a
    # step (PrimaryCaps' dx; Conv1's input needs none).
    print(f"svhn launches: K1 {serve_counts['im2col_patches_f32']} in the "
          f"{SVHN_REQUESTS}-request run (2 sites, once a forward), "
          f"{train_counts['im2col_patches_f32']} in the {TRAIN_STEPS}-step "
          f"run (2 sites, twice a step); K7 "
          f"{train_counts['col2im_patches_f32']} in the {TRAIN_STEPS}-step "
          f"run (once a step)", flush=True)


def attention_work(lens, tq: int, h: int, kvh: int, d: int, causal: bool,
                   window: int | None, q_bytes: int = 4,
                   kv_bytes: int = 4) -> tuple[float, float]:
    """(bytes, flops) K15's function needs on these inputs: q read and o
    written once, each row's visible keys read once from K and V, and
    4 * D flops per (query, visible key) pair and head (q.k and p.v).  A
    row with no valid key weighs all its keys (the mean-of-V rows)."""
    import numpy as np
    nbytes = flops = 0.0
    for kv_len in lens:
        pos = kv_len - tq + np.arange(tq)
        hi = np.minimum(kv_len, pos + 1) if causal else np.full(tq, kv_len)
        lo = (np.maximum(0, pos - window + 1) if window is not None
              else np.zeros(tq, np.int64))
        seen = np.maximum(hi - lo, 0)
        seen = np.where(seen == 0, kv_len, seen)
        keys = kv_len if (causal and pos[0] < 0) else hi.max() - lo.min()
        flops += 4.0 * d * h * float(seen.sum())
        nbytes += (2.0 * tq * h * d * q_bytes
                   + 2.0 * float(keys) * kvh * d * kv_bytes)
    return nbytes, flops


def clocks_during(fn, seconds: float = 1.5) -> dict:
    """The SM clock (MHz) and power draw (W) that ``nvidia-smi`` samples
    every 100 ms while ``fn`` runs back to back for ``seconds``: the
    median of each, and the samples' count.  The sampler is stopped
    before this returns."""
    import torch
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate(timeout=10)
    samples = []
    for line in out.strip().splitlines()[1:]:      # the first: before fn
        try:
            c, w = (float(x) for x in line.split(","))
        except ValueError:                          # "[N/A]" and the like
            continue
        samples.append((c, w))
    clocks = [c for c, _ in samples]
    power = [w for _, w in samples]
    return dict(sm_mhz=statistics.median(clocks) if clocks else None,
                power_w=statistics.median(power) if power else None,
                samples=len(clocks))


def long_decode_sites(dev, cfg) -> tuple[list, tuple]:
    """K15's long-context decode sites: ``LM_SLOTS`` slots x Tq = 1 over
    an ``LM_PROMPT``-key cache holding ``LM_LONG_DECODE`` keys, global and
    window 4096, each with its bytes and flops (``attention_work``) and,
    as the library call, SDPA with the key mask (no softcap).  Returns
    the sites for ``timed_sites`` and the inputs.  It calls only K15's
    public wrapper and its twin, so it also times an earlier tree of the
    port."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as k15
    h, kvh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    scale, cap = cfg.query_scale, cfg.attn_logit_softcap
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    q = torch.randn((LM_SLOTS, 1, h, d), generator=gen, device=dev)
    k = torch.randn((LM_SLOTS, LM_PROMPT, kvh, d), generator=gen, device=dev)
    v = torch.randn((LM_SLOTS, LM_PROMPT, kvh, d), generator=gen, device=dev)
    lens = list(LM_LONG_DECODE)
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    key = torch.arange(LM_PROMPT, device=dev)[None]
    sites = []
    for label, window in (("global", None),
                          (f"window {cfg.sliding_window}",
                           cfg.sliding_window)):
        kw = dict(kv_len=kv_len, causal=True, window=window, softcap=cap,
                  scale=scale)
        mask = key < kv_len[:, None]
        if window is not None:
            mask &= key > kv_len[:, None] - 1 - window
        nbytes, flops = attention_work(lens, 1, h, kvh, d, True, window)
        sites.append((
            f"decode {LM_SLOTS} slots x Tq=1, kv_len {lens} of a "
            f"{LM_PROMPT} cache, {label}, softcap 50",
            lambda kw=kw: k15.flash_attention(q, k, v, **kw),
            lambda kw=kw: k15.flash_attention_plain(q, k, v, **kw),
            lambda m=mask[:, None, None]: F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=m, scale=scale, enable_gqa=True),
            nbytes, flops))
    return sites, (q, k, v, kv_len)


def split_sweep(label: str, call, planned: int, splits_of) -> dict:
    """Device ms of a K15 decode site at each split count of
    ``SPLIT_SWEEP`` (``call(splits=n)``; counts that ``split_keys`` cuts
    to an earlier one are left out), at the planned count, and on the
    prefill schedule (``call(block_k=32)``); one printed line."""
    out = {}
    for n in sorted(set(SPLIT_SWEEP) | {planned}):
        real = splits_of(n)
        if str(real) in out:
            continue
        out[str(real)] = device_ms(lambda n=n: call(splits=n), reps=5)
    out["planned"] = planned
    out["prefill schedule"] = device_ms(lambda: call(block_k=32), reps=5)
    print(f"flash_attention split sweep, {label} (device ms by splits): "
          f"{json.dumps(out)}", flush=True)
    return out


def rms_form(threads: int) -> str:
    """K16's form by its ``threads`` argument."""
    return "warp a row" if threads == 0 else f"CTA a row, {threads} threads"


LM_RECORDS = (("rmsnorm", "rms::rmsnorm"),
              ("flash prefill", "flash::prefill_kernel"),
              ("flash decode", "flash::decode_kernel"),
              ("flash combine", "flash::decode_combine_kernel"))


def kernel_records(prof, parts) -> dict[str, int]:
    """The trace's kernel records whose names hold each of ``parts``."""
    from torch.autograd import DeviceType
    records = dict.fromkeys(parts, 0)
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            for part in parts:
                if part in e.key:
                    records[part] += e.count
    return records


def lm_records(prof) -> dict[str, int]:
    """The trace's kernel records of K16 (every rmsnorm kernel) and of
    K15's three kernels."""
    rec = kernel_records(prof, [part for _, part in LM_RECORDS])
    return {name: rec[part] for name, part in LM_RECORDS}


def tick_profile(eng, reps: int) -> dict:
    """``reps`` steady ticks of ``eng`` (no request admitted or finished
    in them) under ``torch.profiler``: device ms a tick by kernel (the 8
    largest and the total, ``kernel_ms``) and the trace's records a tick
    of K16 and of K15's kernels (``lm_records``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            eng.step()
        torch.cuda.synchronize()
    times: dict[str, float] = {}
    for key, ms in kernel_ms(prof, reps).items():
        times[key[:72]] = times.get(key[:72], 0.0) + ms
    records = lm_records(prof)
    ranked = sorted(times.items(), key=lambda kv: -kv[1])
    return dict(device_ms=sum(times.values()), top=dict(ranked[:8]),
                records_per_tick={k: v / reps for k, v in records.items()},
                kernels_per_tick=sum(
                    e.count for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA) / reps)


def lm_per_forward(cfg) -> dict[str, int]:
    """K15's and K16's launches in one forward of ``cfg``."""
    return {"flash_attention": cfg.num_layers,
            "rmsnorm": 4 * cfg.num_layers + 1}


def lm_params(cfg, dev):
    """gemma2-9b's weights, drawn on the card from the seed."""
    import torch
    from repro_torch.models import transformer as T
    return T.init_model(torch.Generator(device=dev).manual_seed(SEED + 5),
                        cfg, device=dev)


def lm_inputs(cfg):
    """Phase 13's 4608-token prompt and the engine's request lengths and
    prompts, drawn from the seed."""
    import numpy as np
    rng = np.random.default_rng(SEED + 13)
    tokens = rng.integers(0, cfg.vocab_size, (1, LM_PROMPT))
    lo, hi = LM_PROMPT_LENGTHS
    lengths = rng.integers(lo, hi + 1, LM_REQUESTS)
    lengths[:2] = (lo, hi)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in lengths]
    return tokens, lengths, prompts


def lm_engine(params, cfg, dev, prompts, backend, sampler=None,
              cuda_graph=True):
    """A ``ServeEngine`` of LM_SLOTS slots with the requests submitted."""
    from repro_torch.serve.engine import Request, ServeEngine
    eng = ServeEngine(params, cfg, slots=LM_SLOTS, max_len=LM_MAX_LEN,
                      backend=backend, device=dev, sampler=sampler,
                      cuda_graph=cuda_graph)
    for i, p in enumerate(prompts):
        eng.submit(Request(rid=i, prompt=p, max_new_tokens=LM_NEW_TOKENS))
    return eng


def lm_main_path_counted(dev) -> dict:
    """Phase 2b, early in the process: the LM main path, the gemma2-9b
    graph engine serving phase 13's requests, each step profiled
    (``lm_counted_run``).  Frees its weights on return."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as k15
    cfg = registry.get_config(LM_ARCH)
    per_forward = lm_per_forward(cfg)
    params = lm_params(cfg, dev)
    eng = lm_engine(params, cfg, dev, lm_inputs(cfg)[2], "kernels")
    build.reset_launch_counts()
    k15.SCHEDULE_LAUNCHES.update(prefill=0, decode=0)
    counted = lm_counted_run(eng, per_forward)
    counts = build.launch_counts()
    counted["outputs"] = [(r.rid, r.output) for r in counted.pop("done")]
    n_fwd = len(eng.timings["prefill_s"]) + eng.ticks
    seen = n_fwd - counted["replays_untraced"]
    ran = {k: counts[k] + counted["records_on_replays"][k]
           for k in per_forward}
    print(f"LM main path, each step profiled: launches counted by the "
          f"wrappers {json.dumps(counted['counted'])} (the prefills, the "
          f"eager tick, the capture), kernel records "
          f"{json.dumps(counted['records'])}, of them on the "
          f"{counted['replays'] - 1 - counted['replays_untraced']} later "
          f"replays traced whole {json.dumps(counted['records_on_replays'])}"
          f"; counted + on replays {ran} over {seen} forwards "
          f"({counted['replays_untraced']} replays whose trace lost records "
          f"of the step left out: {json.dumps(counted['untraced'])}; steps "
          f"by lead markers lost of {TRACE_LEAD}: "
          f"{json.dumps(counted['lead_lost'])}); one replayed tick "
          f"{json.dumps(counted['one_replay'])}", flush=True)
    if ran != {k: n * seen for k, n in per_forward.items()}:
        raise AssertionError(f"the main path ran {ran} launches over "
                             f"{seen} forwards, not {per_forward} each")
    del params, eng
    gc.collect()
    torch.cuda.empty_cache()
    return counted


def traced(fn):
    """Runs ``fn`` once under ``torch.profiler`` (CUDA activity) between
    marker kernels: TRACE_LEAD ``frac_``, a device spin of
    TRACE_SPIN_CYCLES, TRACE_GUARD ``trunc_``, then ``fn``, then
    TRACE_GUARD ``floor_``, each on a one-float tensor of its own.  The
    trace loses records at the start of a session (TRACE_LEAD's
    comment); the lead markers and the spin take that loss.  Returns the
    profile, whether the trace holds every guard on both sides of
    ``fn`` (so that ``fn``'s records are all there), and how many lead
    markers it lost."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    mark = torch.ones(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_LEAD):
            mark.frac_()
        torch.cuda._sleep(TRACE_SPIN_CYCLES)
        for _ in range(TRACE_GUARD):
            mark.trunc_()
        fn()
        for _ in range(TRACE_GUARD):
            mark.floor_()
        torch.cuda.synchronize()
    rec = kernel_records(prof, ("frac_kernel", "trunc_kernel",
                                "floor_kernel"))
    return (prof, rec["trunc_kernel"] == rec["floor_kernel"] == TRACE_GUARD,
            TRACE_LEAD - rec["frac_kernel"])


def lm_counted_run(eng, per_forward: dict[str, int]) -> dict:
    """Runs ``eng`` (a graph engine) to its end, each step profiled
    (``traced``): the step's kernel records of K16 and K15 (a prefill or
    decode kernel a launch) against the launches its wrappers counted.
    A step never holds more records than launches: one forward beyond
    the count if its tick replayed the graph, none beyond it otherwise
    (prefills, the eager tick, the capture and its one replay).  A step
    whose trace holds its guards holds exactly that many; a replay that
    admits nobody, traced whole, holds 169 K16, 42 K15 decode and 42
    combine records, no prefill.  Returns the wrappers' counts, the
    records, those on the later replays traced whole, one such replay's
    records, the steps whose trace lost records and the replays among
    them, the steps by lead markers lost, and the finished requests."""
    from repro_torch.kernels import build
    totals = {part: dict.fromkeys(per_forward, 0)
              for part in ("counted", "records", "records_on_replays")}
    steps, one_replay, untraced, replays_untraced = 0, None, [], 0
    lead_lost = []
    while eng.queue or any(a is not None for a in eng.active):
        before, replays = build.launch_counts(), eng.graph_replays
        prof, whole, lost = traced(eng.step)
        lead_lost.append(lost)
        after, rec = build.launch_counts(), lm_records(prof)
        ran = {"rmsnorm": rec["rmsnorm"],
               "flash_attention": rec["flash prefill"] + rec["flash decode"]}
        counted = {k: after[k] - before[k] for k in per_forward}
        replayed = (eng.graph_replays - replays == 1
                    and eng.last_tick == "replay")
        extra = {k: ran[k] - counted[k] for k in per_forward}
        want = {k: n if replayed else 0 for k, n in per_forward.items()}
        if (extra != want if whole
                else any(extra[k] > want[k] for k in per_forward)):
            raise AssertionError(f"engine step {steps} ({eng.last_tick}, "
                                 f"traced {'whole' if whole else 'in part'}"
                                 f"): {ran} kernel records, {counted} "
                                 f"launches counted")
        if not whole:
            untraced.append(f"{steps} ({eng.last_tick})")
            replays_untraced += replayed
        elif replayed and not any(counted.values()) and one_replay is None:
            one_replay = rec
            want = {"rmsnorm": per_forward["rmsnorm"], "flash prefill": 0,
                    "flash decode": per_forward["flash_attention"],
                    "flash combine": per_forward["flash_attention"]}
            if rec != want:
                raise AssertionError(f"a replayed tick holds {rec} kernel "
                                     f"records, expected {want}")
        for k in per_forward:
            totals["counted"][k] += counted[k]
            totals["records"][k] += ran[k]
            if whole:
                totals["records_on_replays"][k] += extra[k]
        steps += 1
    if one_replay is None:
        raise AssertionError("no step replayed the tick without a prefill "
                             "and kept its whole trace")
    return dict(steps=steps, ticks=eng.ticks, replays=eng.graph_replays,
                **totals, one_replay=one_replay, untraced=untraced,
                replays_untraced=replays_untraced,
                lead_lost=dict(sorted(Counter(lead_lost).items())),
                done=eng.finished)


def lm_serving(dev, rows: list[dict], counted: dict) -> None:
    """Phase 13, LM serving at the full width of ``gemma2-9b`` (42 layers,
    d_model 3584, 16 heads over 8 KV heads of 256, d_ff 14336, vocab
    256000, window 4096, softcaps 50/30): K16 and K15 against their twins
    at its shapes (and K15 at granite's and chameleon's head dims), one
    4608-token forward on the kernels backend against the plain one, 8
    requests through ``ServeEngine`` on both backends, and the two
    kernels' times beside their bounds, their twins and the library
    calls.  The engine's decode tick runs as a CUDA graph on the main
    path, beside the eager tick.  ``counted`` is phase 2b's profiled run
    of the main path.  Appends the K15 and K16 rows to ``rows``."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import registry
    from repro_torch.core.planner import SMEM_BYTES
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as k15
    from repro_torch.kernels import rmsnorm as k16
    from repro_torch.models import count_params
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = registry.get_config(LM_ARCH)
    h, kvh, d, dm = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, \
        cfg.d_model
    scale, cap, win = cfg.query_scale, cfg.attn_logit_softcap, \
        cfg.sliding_window
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    errs = {"rmsnorm": 0.0, "flash_attention": 0.0}

    def randn(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device=dev).mul_(s)

    # 13a. K16 against its twin at gemma2's rows (D = 3584: a CTA a row,
    # at each CTA size it offers) and at D = 1024 (the sweep's, in both
    # forms).
    x = randn(LM_PROMPT, dm)
    x4 = randn(LM_SLOTS, dm)
    w = randn(dm, s=0.1)
    xb = x.bfloat16()
    xn = randn(LM_PROMPT, RMS_NARROW_D)
    wn = randn(RMS_NARROW_D, s=0.1)
    with torch.no_grad():
        for label, xx, ww, tol in (
                ("[4608, 3584] fp32", x, w, RMS),
                ("[4, 3584] fp32", x4, w, RMS),
                ("[1, 3584] fp32", x4[:1], w, RMS),
                ("[8, 3584] fp32", x[:8], w, RMS),
                ("[4, 3584] bf16", x4.bfloat16(), w, RMS_BF16),
                ("[4608, 3584] bf16", xb, w, RMS_BF16),
                (f"[4608, {RMS_NARROW_D}] fp32", xn, wn, RMS),
                (f"[4, {RMS_NARROW_D}] fp32", xn[:4], wn, RMS)):
            d_ = xx.shape[-1]
            forms = [k16.WARP_ROWS] if d_ <= k16.WARP_MAX_D else []
            for threads in [None, *forms, *k16.CTA_THREADS]:
                got = (k16.rmsnorm(xx, ww) if threads is None
                       else k16.rmsnorm_form(xx, ww, threads))
                form = k16.plan(d_, 16 // xx.element_size()) \
                    if threads is None else threads
                r = check(f"rmsnorm {label} ({rms_form(form)}"
                          f"{', planned' if threads is None else ''})",
                          got.float(), k16.rmsnorm_plain(xx, ww).float(),
                          tol)
                if xx.dtype == torch.float32 and d_ == dm:
                    errs["rmsnorm"] = max(errs["rmsnorm"], r["max_abs"])

    # 13b. K15 against its twin at gemma2's heads (and two other dims).
    def qkv(b, tq, tk, hh=h, kk=kvh, dd=d):
        return (randn(b, tq, hh, dd), randn(b, tk, kk, dd),
                randn(b, tk, kk, dd))

    mixed = list(LM_LONG_DECODE)                    # two past the window
    flash_cases = [
        ("prefill T=128 global", qkv(1, 128, 128), None, {}),
        ("prefill T=300 global (ragged tail)", qkv(1, 300, 300), None, {}),
        ("prefill T=4608 local (window 4096)", qkv(1, LM_PROMPT, LM_PROMPT),
         None, dict(window=win)),
        ("prefill T=4608 global", qkv(1, LM_PROMPT, LM_PROMPT), None, {}),
        ("decode Tq=1 local, kv_len " + str(mixed),
         qkv(4, 1, LM_PROMPT), mixed, dict(window=win)),
        ("decode Tq=1 global, kv_len " + str(mixed),
         qkv(4, 1, LM_PROMPT), mixed, {}),
        ("decode Tq=1, kv_len [5000, 0, 300, 17] (clamped to Tk; an empty "
         "row is 0)", qkv(4, 1, LM_PROMPT), [5000, 0, 300, 17],
         dict(window=win)),
        ("Tq=300 > Tk=128 causal (mean-of-V rows)", qkv(1, 300, 128), None,
         {}),
        ("granite D=64 (H 32, KvH 8) T=300", qkv(1, 300, 300, 32, 8, 64),
         None, dict(scale=None, softcap=None)),
        ("chameleon D=128 (H 64, KvH 8) T=300",
         qkv(1, 300, 300, 64, 8, 128), None, dict(scale=None, softcap=None)),
    ]
    with torch.no_grad():
        for label, (q, k, v), lens, extra in flash_cases:
            kw = dict(causal=True, window=None, softcap=cap, scale=scale)
            kw.update(extra)
            kv_len = (torch.tensor(lens, dtype=torch.int32, device=dev)
                      if lens else None)
            got = k15.flash_attention(q, k, v, kv_len=kv_len, **kw)
            want = k15.flash_attention_plain(q, k, v, kv_len=kv_len, **kw)
            r = check(f"flash_attention {label} ({k15.schedule(q, k)})",
                      got, want, FLASH)
            errs["flash_attention"] = max(errs["flash_attention"],
                                          r["max_abs"])
            del q, k, v, got, want
        # The long-context decode site at the planned splits: against the
        # split twin (same partials, same combine order; the cases above
        # hold both schedules to the direct twin) and twice for identical
        # bits; the prefill schedule at T = 4608 twice likewise.
        sites_long, (ql, kl, vl, lenl) = long_decode_sites(dev, cfg)
        planned_long = k15.plan_decode(LM_SLOTS, kvh, h // kvh, LM_PROMPT, d)
        for label, window in (("global", None), (f"window {win}", win)):
            kw = dict(kv_len=lenl, causal=True, window=window, softcap=cap,
                      scale=scale)
            name = (f"flash_attention decode kv_len {mixed} {label} "
                    f"({k15.schedule(ql, kl)})")
            got = same_bits(name, lambda kw=kw: k15.flash_attention(
                ql, kl, vl, **kw))
            want = k15.flash_decode_plain(ql, kl, vl, splits=planned_long,
                                          **kw)
            r = check(f"{name} against the split twin at {planned_long} "
                      f"splits", got, want, FLASH)
            errs["flash_attention"] = max(errs["flash_attention"],
                                          r["max_abs"])
        del sites_long, ql, kl, vl, lenl
        qp, kp, vp = qkv(1, LM_PROMPT, LM_PROMPT)
        same_bits(f"flash_attention prefill T={LM_PROMPT} global "
                  f"({k15.schedule(qp, kp)})",
                  lambda: k15.flash_attention(qp, kp, vp, softcap=cap,
                                              scale=scale))
        del qp, kp, vp
    torch.cuda.empty_cache()

    # 13c. The full-width model: one 4608-token forward, kernels vs plain.
    t0 = time.perf_counter()
    params = lm_params(cfg, dev)
    torch.cuda.synchronize()
    print(f"{LM_ARCH}: {count_params(cfg)} parameters "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card) "
          f"drawn in {time.perf_counter() - t0:.1f} s", flush=True)
    tokens, lengths, prompts = lm_inputs(cfg)
    per_forward = lm_per_forward(cfg)
    fwd_s = {}
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        logits = {}
        for backend in ("kernels", "torch"):
            build.reset_launch_counts()
            t0 = time.perf_counter()
            logits[backend] = T.forward(params, tokens, cfg=cfg,
                                        backend=backend)[0][0]
            torch.cuda.synchronize()
            fwd_s[backend] = time.perf_counter() - t0
            counts = build.launch_counts()
            want_counts = (per_forward if backend == "kernels"
                           else dict.fromkeys(per_forward, 0))
            got_counts = {kk: counts[kk] for kk in per_forward}
            if got_counts != want_counts:
                raise AssertionError(f"forward ({backend}): launches "
                                     f"{got_counts}, expected {want_counts}")
        lk, lt = logits["kernels"], logits["torch"]
        logit_err = check_scaled(f"{LM_ARCH} logits [4608, 256000]", lk, lt,
                                 LOGITS)
        ak, at = lk.argmax(-1), lt.argmax(-1)
        flips = torch.nonzero(ak != at).flatten().tolist()
        for pos in flips:
            gap = float(lt[pos, at[pos]] - lt[pos, ak[pos]])
            print(f"  argmax differs at position {pos}: kernels "
                  f"{int(ak[pos])}, plain {int(at[pos])}, plain gap "
                  f"{gap:.3e}", flush=True)
            if gap > 2 * logit_err:
                raise AssertionError(f"argmax at position {pos} differs by "
                                     f"more than the logits' error")
        print(f"check {LM_ARCH} argmax: equal at {LM_PROMPT - len(flips)}/"
              f"{LM_PROMPT} positions; the rest are ties within twice the "
              f"max logit error {logit_err:.3e}", flush=True)
        print(f"{LM_ARCH} forward of {LM_PROMPT} tokens: kernels "
              f"{fwd_s['kernels']:.3f} s, plain {fwd_s['torch']:.3f} s; peak "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        del logits, lk, lt, ak, at
    torch.cuda.empty_cache()

    # 13d. The engine: 8 requests through 4 slots, kernels vs plain.
    gaps: dict[tuple[int, int], float] = {}

    def recording_sampler(lg):           # the plain engine's decode gaps
        if lg.shape[0] == LM_SLOTS:
            for s_, req in enumerate(eng_r.active):
                if req is not None:
                    top = np.sort(lg[s_])[-2:]
                    gaps[(req.rid, len(req.output))] = float(top[1] - top[0])
        return np.argmax(lg, -1)

    def serve(backend, sampler=None, cuda_graph=True):
        return lm_engine(params, cfg, dev, prompts, backend, sampler,
                         cuda_graph)

    # Three timed runs, each taking the argmax on the device: the kernels
    # engine with its tick as a CUDA graph (the main path), the same engine
    # ticking eagerly, and the plain engine (eager, as before the graph).
    # The plain top-2 gaps come from a fourth, untimed plain run whose
    # sampler records them on the host (its tokens must equal the timed
    # plain run's).
    served = {}
    for name, backend, graph in (("kernels", "kernels", True),
                                 ("kernels eager", "kernels", False),
                                 ("torch", "torch", False)):
        eng = serve(backend, cuda_graph=graph)
        build.reset_launch_counts()
        k15.SCHEDULE_LAUNCHES.update(prefill=0, decode=0)
        t0 = time.perf_counter()
        done = eng.run()
        run_s = time.perf_counter() - t0
        counts = build.launch_counts()
        served[name] = dict(engine=eng, done=done, run_s=run_s,
                            counts=counts,
                            schedules=dict(k15.SCHEDULE_LAUNCHES))
    eng_r = serve("torch", recording_sampler, cuda_graph=False)
    recorded = {r.rid: r.output for r in eng_r.run()}
    if recorded != {r.rid: r.output for r in served["torch"]["done"]}:
        raise AssertionError("the plain engine's tokens differ between its "
                             "timed run and its recording run")
    del eng_r
    eng_k = served["kernels"]["engine"]
    n_ticks = eng_k.ticks
    kinds = dict(eng_k.tick_kinds)
    print(f"graph engine ticks: {kinds}, {eng_k.graph_replays} graph "
          f"replays", flush=True)
    # Tick 1 warms up eagerly, tick 2 captures (and replays once), the
    # rest replay.
    if kinds != {"eager": 1, "capture": 1, "replay": n_ticks - 2} \
            or eng_k.graph_replays != n_ticks - 1:
        raise AssertionError(f"the graph engine's ticks ran as {kinds} "
                             f"with {eng_k.graph_replays} replays")
    eng_e = served["kernels eager"]["engine"]
    if dict(eng_e.tick_kinds) != {"eager": eng_e.ticks} \
            or eng_e.graph_replays:
        raise AssertionError("the eager engine replayed a graph")
    # The wrappers count on the host: every prefill and eager tick, and
    # the capture (whose launches run at its one replay); a replay counts
    # nothing.
    for name, eager_fwd in (("kernels", 2), ("kernels eager", eng_e.ticks)):
        eng = served[name]["engine"]
        n_pre = len(eng.timings["prefill_s"])
        got_counts = {kk: served[name]["counts"][kk] for kk in per_forward}
        want_counts = {kk: n * (n_pre + eager_fwd)
                       for kk, n in per_forward.items()}
        print(f"engine ({name}) launches counted by the wrappers over "
              f"{n_pre} prefills and {eager_fwd} ticks (eager or captured): "
              f"{got_counts}, expected {want_counts}", flush=True)
        if got_counts != want_counts:
            raise AssertionError(f"the {name} engine did not run every "
                                 f"attention on K15 and every norm on K16")
        # Every prefill (B = 1, Tq = 17..300: 34+ query rows a KV head) on
        # the prefill schedule, every decode tick (4 slots x Tq = 1) on
        # decode.
        schedules = served[name]["schedules"]
        want_sched = {"prefill": cfg.num_layers * n_pre,
                      "decode": cfg.num_layers * eager_fwd}
        print(f"engine ({name}) K15 launches by schedule: {schedules}, "
              f"expected {want_sched}", flush=True)
        if schedules != want_sched:
            raise AssertionError(f"the {name} engine's K15 calls did not "
                                 f"take the planned schedules")
    graph_out = [(r.rid, r.output) for r in served["kernels"]["done"]]
    eager_out = [(r.rid, r.output) for r in served["kernels eager"]["done"]]
    if graph_out != eager_out:
        raise AssertionError("the graph engine's tokens or finish order "
                             "differ from the eager kernels engine's")
    print(f"check graph engine: tokens and finish order equal to the eager "
          f"kernels engine's, all {LM_REQUESTS} requests", flush=True)
    if counted["outputs"] != graph_out:
        raise AssertionError("the profiled main path's tokens (phase 2b) "
                             "differ from the timed graph engine's")
    engine_counts = served["kernels"]["counts"]
    order = {b: [r.rid for r in served[b]["done"]] for b in served}
    if order["kernels"] != order["torch"]:
        raise AssertionError(f"finish order differs: {order}")
    by_rid = {b: {r.rid: r for r in served[b]["done"]} for b in served}
    ties = 0
    for rid in range(LM_REQUESTS):
        ok_, ot_ = by_rid["kernels"][rid].output, by_rid["torch"][rid].output
        if len(ok_) != LM_NEW_TOKENS or len(ot_) != LM_NEW_TOKENS:
            raise AssertionError(f"request {rid}: {len(ok_)} / {len(ot_)} "
                                 f"tokens, expected {LM_NEW_TOKENS}")
        for j, (a_, b_) in enumerate(zip(ok_, ot_)):
            if a_ == b_:
                continue
            if j == 0:
                top = np.sort(by_rid["torch"][rid].prefill_logits)[-2:]
                gap = float(top[1] - top[0])
            else:
                gap = gaps[(rid, j)]
            print(f"  request {rid} token {j}: kernels {a_}, plain {b_}, "
                  f"plain top-2 gap {gap:.3e}", flush=True)
            if gap > 2 * logit_err:
                raise AssertionError(f"request {rid} token {j} differs "
                                     f"beyond a tie")
            ties += 1
            break                        # the continuations diverge
    print(f"check engine tokens: {LM_REQUESTS - ties}/{LM_REQUESTS} requests "
          f"equal to the plain engine's, {ties} diverge at a tie; finish "
          f"order {order['kernels']}", flush=True)
    stats = {}
    for name, sv in served.items():
        tm = sv["engine"].timings
        n_tok = sum(len(r.output) for r in sv["done"])
        stats[name] = dict(
            prefill_ms_mean=1e3 * statistics.mean(tm["prefill_s"]),
            prefill_ms=[1e3 * t_ for t_ in tm["prefill_s"]],
            decode_ms_per_tick_median=1e3 * statistics.median(
                tm["decode_s"]),
            decode_ms_by_tick=[1e3 * t_ for t_ in tm["decode_s"]],
            tick_kinds=dict(sv["engine"].tick_kinds),
            ticks=len(tm["decode_s"]), tokens=n_tok, run_s=sv["run_s"],
            tokens_per_s=n_tok / sv["run_s"])
    # The graph engine's ticks after the eager one and the capture.
    stats["kernels"]["replay_ms_median"] = statistics.median(
        stats["kernels"]["decode_ms_by_tick"][2:])
    stats["prompt_lengths"] = lengths.tolist()
    print(f"lm_engine: {json.dumps(stats)}", flush=True)

    # 13e. Times at the path's shapes: K16 and K15 beside their bounds,
    # their twins and the library calls (timed here, never called by the
    # port); a profile of one decode tick and of the 4608 forward.
    lens_dec = [int(n) + LM_NEW_TOKENS // 2 for n in lengths[:LM_SLOTS]]
    kv_dec = torch.tensor(lens_dec, dtype=torch.int32, device=dev)
    qd = randn(LM_SLOTS, 1, h, d)
    kd, vd = eng_k.cache["blocks"]["s1"]["k"][0], \
        eng_k.cache["blocks"]["s1"]["v"][0]
    qp, kp, vp = qkv(1, LM_PROMPT, LM_PROMPT)
    w1 = 1.0 + w
    keymask = (torch.arange(LM_MAX_LEN, device=dev)[None]
               < kv_dec[:, None].long())[:, None, None, :]
    planned_dec = k15.plan_decode(LM_SLOTS, kvh, h // kvh, LM_MAX_LEN, d)
    # The decode site at the engine's shape (most of its splits past the
    # rows' keys) against both twins, and twice for identical bits.
    with torch.no_grad():
        kw_dec = dict(kv_len=kv_dec, softcap=cap, scale=scale)
        name = (f"flash_attention decode kv_len {lens_dec} of a "
                f"{LM_MAX_LEN} cache ({k15.schedule(qd, kd)})")
        got = same_bits(name, lambda: k15.flash_attention(qd, kd, vd,
                                                          **kw_dec))
        for twin, want in (
                ("the direct twin",
                 k15.flash_attention_plain(qd, kd, vd, **kw_dec)),
                (f"the split twin at {planned_dec} splits",
                 k15.flash_decode_plain(qd, kd, vd, splits=planned_dec,
                                        **kw_dec))):
            r = check(f"{name} against {twin}", got, want, FLASH)
            errs["flash_attention"] = max(errs["flash_attention"],
                                          r["max_abs"])
        del got, want

    def sdpa(q_, k_, v_, **kw):
        return F.scaled_dot_product_attention(
            q_.transpose(1, 2), k_.transpose(1, 2), v_.transpose(1, 2),
            scale=scale, enable_gqa=True, **kw)

    def fa_site(label, q_, k_, v_, kv_len, lens, window, softcap, lib):
        kw = dict(kv_len=kv_len, causal=True, window=window,
                  softcap=softcap, scale=scale)
        nbytes, flops = attention_work(lens, q_.shape[1], h, kvh, d, True,
                                       window)
        return (label, lambda: k15.flash_attention(q_, k_, v_, **kw),
                lambda: k15.flash_attention_plain(q_, k_, v_, **kw), lib,
                nbytes, flops)

    full = [LM_PROMPT]
    sites_long, (ql, kl, vl, lenl) = long_decode_sites(dev, cfg)
    with torch.no_grad():
        fa_sites = timed_sites([
            fa_site("prefill T=4608 global, softcap 50 (main path)", qp, kp,
                    vp, None, full, None, cap, None),
            fa_site("prefill T=4608 local (window 4096), softcap 50", qp, kp,
                    vp, None, full, win, cap, None),
            fa_site(f"decode 4 slots x Tq=1, kv_len {lens_dec} of a 512 "
                    f"cache, softcap 50", qd, kd, vd, kv_dec, lens_dec, None,
                    cap, lambda: sdpa(qd, kd, vd, attn_mask=keymask)),
            *sites_long,
            fa_site("prefill T=4608 global, no softcap (vs SDPA)", qp, kp,
                    vp, None, full, None, None,
                    lambda: sdpa(qp, kp, vp, is_causal=True)),
        ])
        # The decode sites by split count, the planned one marked.
        planned_long = k15.plan_decode(LM_SLOTS, kvh, h // kvh, LM_PROMPT, d)
        sweeps = {
            "engine decode (512 cache)": split_sweep(
                f"decode kv_len {lens_dec} of a 512 cache",
                lambda **sk: k15.flash_attention(
                    qd, kd, vd, kv_len=kv_dec, softcap=cap, scale=scale,
                    **sk), planned_dec,
                lambda n: k15.split_keys(LM_MAX_LEN, n)[0])}
        for label, window in (("global", None), (f"window {win}", win)):
            sweeps[f"long decode (4608 cache), {label}"] = split_sweep(
                f"decode kv_len {list(LM_LONG_DECODE)} of a 4608 cache, "
                f"{label}",
                lambda window=window, **sk: k15.flash_attention(
                    ql, kl, vl, kv_len=lenl, window=window, softcap=cap,
                    scale=scale, **sk), planned_long,
                lambda n: k15.split_keys(LM_PROMPT, n)[0])
        del sites_long, ql, kl, vl, lenl
        # The engine's shortest and longest prompt, one row over its
        # 512-key cache: 34 and 600 query rows a KV head, past the decode
        # schedule's 8, so the prefill schedule on 1 and 5 q blocks a head.
        prompt_ms = {}
        for n in LM_PROMPT_LENGTHS:
            qn, kn, vn = qkv(1, n, LM_MAX_LEN)
            ln = torch.tensor([n], dtype=torch.int32, device=dev)
            prompt_ms[str(n)] = dict(
                schedule=str(k15.schedule(qn, kn)),
                ctas=-(-n // k15.BLOCK_Q) * h,
                device_ms=device_ms(lambda: k15.flash_attention(
                    qn, kn, vn, kv_len=ln, softcap=cap, scale=scale),
                    reps=10))
            del qn, kn, vn
        print(f"flash_attention at the engine's prompts (512 cache): "
              f"{json.dumps(prompt_ms)}", flush=True)
        # The card's clock and power under the main prefill site.
        prefill_clocks = clocks_during(lambda: k15.flash_attention(
            qp, kp, vp, softcap=cap, scale=scale))
        print(f"flash_attention prefill T={LM_PROMPT} global, run back to "
              f"back: {json.dumps(prefill_clocks)}", flush=True)
        xd = x4

        def rms_site(label, xx):
            return (label, lambda: k16.rmsnorm(xx, w),
                    lambda: k16.rmsnorm_plain(xx, w),
                    lambda: F.rms_norm(xx, (dm,), w1.to(xx.dtype), 1e-6),
                    2.0 * xx.numel() * xx.element_size() + 4.0 * dm,
                    4.0 * xx.numel())

        rms_sites = timed_sites([
            rms_site("prefill [4608, 3584] fp32 (main path)", x),
            rms_site("decode [4, 3584] fp32", xd),
            rms_site("prefill [4608, 3584] bf16", xb),
            rms_site("decode [1, 3584] fp32", x4[:1]),
            rms_site("decode [8, 3584] fp32", x[:8])])
        # K16's forms by rows: at D = 3584 a CTA a row at each CTA size,
        # at D = 1024 also a warp a row, the planned form marked; and the
        # floor under the decode launch, an empty kernel of its grid.
        form_sweep = {}
        for xx, ww, rows_ in (
                (x, w, (1, 4, 8, 33, 132, 264, 528, 1056, 4608)),
                (xb, w, (4, 132, 264, 1056, 4608)),
                (xn, wn, (4, 132, 4608))):
            d_ = xx.shape[-1]
            forms = [k16.WARP_ROWS] if d_ <= k16.WARP_MAX_D else []
            for r_ in rows_:
                xr_ = xx[:r_]
                site = f"[{r_}, {d_}] {str(xx.dtype)[6:]}"
                form_sweep[site] = {
                    rms_form(t_): device_ms(
                        lambda t_=t_, xr_=xr_, ww=ww: k16.rmsnorm_form(
                            xr_, ww, t_), reps=10)
                    for t_ in (*forms, *k16.CTA_THREADS)}
                form_sweep[site]["planned"] = rms_form(
                    k16.plan(d_, 16 // xx.element_size()))
        print(f"rmsnorm device ms by form: {json.dumps(form_sweep)}",
              flush=True)
        # K16 against F.rms_norm, device time in turns (kernel, library,
        # library, kernel), at the 4608-row and the decode sites.  The
        # sites' event ms are host-paced at decode for both.
        rms_vs_lib = {}
        for xx in (x, xb, x4, x4[:1], x[:8]):
            w1x = w1.to(xx.dtype)
            turns = []
            for fn in ("k16", "lib", "lib", "k16"):
                turns.append(device_ms(
                    (lambda xx=xx: k16.rmsnorm(xx, w)) if fn == "k16" else
                    (lambda xx=xx, w1x=w1x: F.rms_norm(xx, (dm,), w1x,
                                                       1e-6)), reps=20))
            rms_vs_lib[f"[{xx.shape[0]}, {dm}] {str(xx.dtype)[6:]}"] = dict(
                k16=[turns[0], turns[3]], f_rms_norm=[turns[1], turns[2]])
        print(f"rmsnorm against F.rms_norm, device ms in turns: "
              f"{json.dumps(rms_vs_lib)} ({CARD})", flush=True)
        dec_key = f"[{LM_SLOTS}, {dm}] float32"
        dec_threads = k16.plan(dm, 4)
        rms_empty = dict(grid=[LM_SLOTS, dec_threads],
                         ms=time_ms(lambda: k16.empty_launch(
                             LM_SLOTS, dec_threads, dev)),
                         device_ms=device_ms(lambda: k16.empty_launch(
                             LM_SLOTS, dec_threads, dev)))
        print(f"rmsnorm decode [4, 3584] fp32 ({rms_form(dec_threads)}): "
              f"device {rms_sites[1]['device_ms']} ms, bound "
              f"{rms_sites[1]['bound_ms']:.7f} ms, empty launch of its grid "
              f"{json.dumps(rms_empty)}, F.rms_norm in turns "
              f"{rms_vs_lib[dec_key]['f_rms_norm']} ms; [4608, 3584] bf16: "
              f"device {rms_sites[2]['device_ms']} ms, F.rms_norm "
              f"{rms_sites[2]['library_ms']} ms ({CARD})", flush=True)
        # K15's prefill KV tile at the three head dims (plan_tiles picks
        # 32, 64, 32 keys for D = 64, 128, 256), each timed with every tile
        # that fits a CTA (only 32 keys at D = 256).
        tile_sweep = {}
        for label, (hh, kk, dd, tt) in (("granite D=64 T=4096", (32, 8, 64,
                                                                 4096)),
                                        ("chameleon D=128 T=2048",
                                         (64, 8, 128, 2048)),
                                        ("gemma2 D=256 T=4608",
                                         (h, kvh, d, LM_PROMPT))):
            qs, ks, vs = qkv(1, tt, tt, hh, kk, dd)
            for bk in k15.BLOCK_K_CHOICES:
                if k15.smem_bytes(dd, bk) > SMEM_BYTES:
                    continue
                tile_sweep[f"{label} block_k {bk}"] = device_ms(
                    lambda bk=bk: k15.flash_attention(qs, ks, vs,
                                                      softcap=cap,
                                                      block_k=bk), reps=5)
            tile_sweep[f"{label} planned"] = k15.plan_tiles(dd)[1]
            del qs, ks, vs
        print(f"flash_attention device ms by block_k: "
              f"{json.dumps(tile_sweep)}", flush=True)
        prefill_profile = device_breakdown(lambda: T.forward(
            params, tokens, cfg=cfg, backend="kernels", last_only=True),
            reps=1, top=8)
    print(f"lm profile, one 4608-token forward (device ms by kernel): "
          f"{json.dumps(prefill_profile)}", flush=True)
    # Steady decode ticks of the graph engine (replays) and of the eager
    # kernels engine, profiled: LM_SLOTS fresh requests fill the slots, a
    # tick admits them, then only ticks run.  The idle share sets each
    # tick's device ms against its engine's median host ms in the timed
    # run (the profiler slows the host).
    tick_profiles = {}
    for name in ("kernels", "kernels eager"):
        eng = served[name]["engine"]
        for i, p in enumerate(prompts[:LM_SLOTS]):
            eng.submit(Request(rid=100 + i, prompt=p,
                               max_new_tokens=LM_NEW_TOKENS))
        eng.step()
        eng.step()
        replays = eng.graph_replays
        one = tick_profile(eng, 1)
        three = tick_profile(eng, 3)
        host_ms = (stats[name]["replay_ms_median"] if name == "kernels"
                   else stats[name]["decode_ms_per_tick_median"])
        tick_profiles[name] = dict(
            last_tick=eng.last_tick,
            replays_profiled=eng.graph_replays - replays, one_tick=one,
            device_ms=three["device_ms"], top=three["top"],
            kernels_per_tick=three["kernels_per_tick"],
            host_ms=host_ms, idle_share=1.0 - three["device_ms"] / host_ms)
        print(f"lm decode tick ({name}, {eng.last_tick}): host "
              f"{host_ms:.3f} ms, device {three['device_ms']:.3f} ms, idle "
              f"share {tick_profiles[name]['idle_share']:.3f}, "
              f"{three['kernels_per_tick']:.0f} kernels a tick; the trace "
              f"kept {json.dumps(one['records_per_tick'])} records of one "
              f"tick ({CARD})", flush=True)
        print(f"lm profile, one decode tick ({name}; device ms by kernel): "
              f"{json.dumps(three['top'])}", flush=True)
    # Late in the process the trace keeps fewer records of a replay than
    # it ran (phase 2b holds every step's records early); check only
    # that the profiled ticks replayed.
    if tick_profiles["kernels"]["replays_profiled"] != 4:
        raise AssertionError("the graph engine's profiled ticks did not "
                             "all replay")
    for name, source, replaces, site_rows, lib_note in (
            ("flash_attention", "flash_attention.cu",
             "src/repro/kernels/flash_attention.py:29", fa_sites,
             "no PyTorch call computes the softcapped form: library_ms is "
             "F.scaled_dot_product_attention (is_causal, enable_gqa) at the "
             "main shape without softcap, against K15 without softcap in "
             "the last site"),
            ("rmsnorm", "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:18",
             rms_sites, "F.rms_norm(x, (D,), 1 + w, eps)")):
        main_site = site_rows[0]
        library_ms = (site_rows[-1]["library_ms"] if name == "flash_attention"
                      else main_site["library_ms"])
        if name == "flash_attention":
            def sched(site, lib_site, **extra):
                return dict(site=site["op"], device_ms=site["device_ms"],
                            ms=site["ms"], bound_ms=site["bound_ms"],
                            bound_by=site["bound_by"],
                            library_ms=lib_site["library_ms"], **extra)
            schedules = dict(
                prefill=sched(site_rows[0], site_rows[-1],
                              block_k=k15.schedule(qp, kp).block_k,
                              launches=served["kernels"]["schedules"][
                                  "prefill"]),
                decode=sched(site_rows[2], site_rows[2], splits=planned_dec,
                             launches=served["kernels"]["schedules"][
                                 "decode"]),
                decode_long=sched(site_rows[3], site_rows[3],
                                  splits=planned_long))
        row = dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{source}",
            replaces=replaces, launches=engine_counts[name],
            launches_on_replays=counted["records_on_replays"][name],
            launches_note="launches: what the wrappers counted over the "
                          "timed main path (prefills, the eager tick, the "
                          "capture); launches_on_replays: the kernel "
                          "records of the later graph replays of phase "
                          "2b's run of the main path, each step profiled, "
                          "over the replays traced whole",
            replays_untraced=counted["replays_untraced"],
            forward_launches=per_forward[name], max_abs_err=errs[name],
            ms=main_site["ms"], device_ms=main_site["device_ms"],
            plain_ms=main_site["plain_ms"], bound_ms=main_site["bound_ms"],
            bound_by=main_site["bound_by"], library_ms=library_ms,
            library_note=lib_note,
            tile_sweep=tile_sweep if name == "flash_attention" else None,
            path=f"{LM_ARCH} served by ServeEngine(backend='kernels'): "
                 f"{LM_REQUESTS} requests, {LM_SLOTS} slots",
            sites=site_rows)
        if name == "flash_attention":
            row.update(schedules=schedules, split_sweep=sweeps,
                       engine_prompts=prompt_ms)
        else:
            dec = site_rows[1]
            row.update(decode=dict(
                site=dec["op"], form=rms_form(dec_threads),
                device_ms=dec["device_ms"], ms=dec["ms"],
                bound_ms=dec["bound_ms"], bound_by=dec["bound_by"],
                library_ms=dec["library_ms"],
                library_device_ms=rms_vs_lib[dec_key]["f_rms_norm"],
                device_ms_in_turns=rms_vs_lib[dec_key]["k16"],
                empty_launch=rms_empty),
                form_sweep=form_sweep, against_library=rms_vs_lib)
        rows.append(row)
    print(f"lm decode ticks: {json.dumps(tick_profiles)}", flush=True)
    del params, eng_k, served
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    global CARD
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: the repro_torch package is not beside this "
              "script (run it from the root of a checkout)", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. The card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    CARD = smi
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # 2. Build the kernels from the checkout's sources.
    t0 = time.perf_counter()
    built = build.build()
    print(f"build: compiled {built or 'nothing (up to date)'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # 2b. The LM main path with each step profiled.
    lm_counted = lm_main_path_counted(dev)
    # 3.-12. The CapsuleNet phases; their tensors are freed on return.
    rows = capsnet_phases(dev)
    gc.collect()
    torch.cuda.empty_cache()
    # 13. LM serving at the full width of gemma2-9b.
    lm_serving(dev, rows, lm_counted)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def capsnet_phases(dev) -> list[dict]:
    """Phases 3-12 at the CapsuleNet's shapes; returns the kernels' rows."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import capsnet_mnist, capsnet_svhn
    from repro_torch.core import capsnet, execplan, planner
    from repro_torch.kernels import build
    from repro_torch.kernels import caps_votes as k14a
    from repro_torch.kernels import conv_im2col as k12
    from repro_torch.kernels import ops
    from repro_torch.kernels import primary_routing as k5
    from repro_torch.kernels import routing as k14b
    from repro_torch.kernels import squash as k10
    from repro_torch.kernels import votes_routing as k34
    from repro_torch.serve.capsule import CapsRequest, CapsuleEngine
    from repro_torch.train import capsnet_loop

    # Full-width MNIST CapsuleNet, random weights from the seed.
    cfg = capsnet_mnist.config()
    smoke = capsnet_mnist.smoke_config()
    params = capsnet.init_params(torch.Generator().manual_seed(SEED), cfg,
                                 device=dev)
    sparams = capsnet.init_params(torch.Generator().manual_seed(SEED + 1),
                                  smoke, device=dev)
    rng = np.random.default_rng(SEED)
    images = torch.tensor(
        rng.random((SLOTS, cfg.image_hw, cfg.image_hw, 1), np.float32),
        device=dev)
    simages = torch.tensor(
        rng.random((SLOTS, smoke.image_hw, smoke.image_hw, 1), np.float32),
        device=dev)
    plan = execplan.compile_plan(cfg, batch=SLOTS, pipeline=True)
    perop = execplan.compile_plan(cfg, batch=SLOTS, pipeline=False)
    splan = execplan.compile_plan(smoke, batch=SLOTS, pipeline=True)
    sperop = execplan.compile_plan(smoke, batch=SLOTS, pipeline=False)
    for name, p in (("MNIST pipelined", plan), ("MNIST per-op", perop),
                    ("smoke pipelined", splan), ("smoke per-op", sperop)):
        print(f"plan {name}: {json.dumps(p.summary())}", flush=True)

    # Activations at the path's shapes, from the plain path.
    x1, u = conv_inputs(cfg, params, images)
    sx1, su = conv_inputs(smoke, sparams, simages)
    k1, kp = cfg.conv1_kernel, cfg.pc_kernel
    w1 = params["conv1_w"].reshape(-1, cfg.conv1_channels)
    wpc = params["pc_w"].reshape(-1, cfg.pc_channels)
    lay = cfg.routing_stack()[0]
    wcc = params["cc_w"].reshape(lay.in_caps, lay.jd, lay.in_dim)
    slay = smoke.routing_stack()[0]
    swcc = sparams["cc_w"].reshape(slay.in_caps, slay.jd, slay.in_dim)
    swpc = sparams["pc_w"].reshape(-1, smoke.pc_channels)
    c1, pc = plan.op("Conv1").block, perop.op("PrimaryCaps").block
    svcfg = capsnet_svhn.config()
    svpc = execplan.compile_plan(svcfg, batch=SLOTS,
                                 pipeline=False).op("PrimaryCaps").block
    svx1, svw, svb = svhn_pc_inputs(dev)
    psv = k12.im2col_patches_plain(svx1, kh=svcfg.pc_kernel,
                                   kw=svcfg.pc_kernel, stride=svcfg.pc_stride)
    psv = psv.reshape(psv.shape[0] * psv.shape[1], -1)
    wsv = svw.reshape(-1, svcfg.pc_channels)
    vr, pr = perop.op(execplan.FUSED_NAME), plan.op(execplan.PIPE_NAME)
    # K4 with streamed votes named at MNIST width: the planner's cluster.
    mst = execplan.plan_votes_routing_cluster(
        lay.in_caps, lay.in_dim, lay.jd, lay.num_caps, batch=SLOTS,
        votes="streamed")
    svr, spr = sperop.op(execplan.FUSED_NAME), splan.op(execplan.PIPE_NAME)
    p1 = k12.im2col_patches_plain(images, kh=k1, kw=k1)
    ppc = k12.im2col_patches_plain(x1, kh=kp, kw=kp, stride=cfg.pc_stride)
    sppc = k12.im2col_patches_plain(sx1, kh=smoke.pc_kernel,
                                    kw=smoke.pc_kernel,
                                    stride=smoke.pc_stride)
    m1, mpc = p1.shape[0] * p1.shape[1], ppc.shape[0] * ppc.shape[1]

    # 3. Every kernel against its plain twin on the card.
    errs: dict[str, float] = {}

    def held(kernel: str, name: str, got, want, tol) -> None:
        r = check(name, got, want, tol)
        errs[kernel] = max(errs.get(kernel, 0.0), r["max_abs"])

    # K1 at both sites, twice each for identical bits.
    held("im2col_patches", "K1 im2col Conv1",
         same_bits("K1 Conv1", lambda: k12.im2col_patches(
             images, kh=k1, kw=k1)), p1, EXACT)
    held("im2col_patches", "K1 im2col PrimaryCaps",
         same_bits("K1 PrimaryCaps", lambda: k12.im2col_patches(
             x1, kh=kp, kw=kp, stride=cfg.pc_stride)), ppc, EXACT)
    # K2 at each forward site (the SVHN PrimaryCaps shape on seeded
    # inputs), against its twin summed in the kernel's split order; each
    # twice, for identical bits.
    gemm_sites = {
        "Conv1": (p1.reshape(m1, -1), w1, params["conv1_b"], c1,
                  dict(epilogue="relu"), SHORT_SUM),
        "PrimaryCaps": (ppc.reshape(mpc, -1), wpc, params["pc_b"], pc,
                        dict(epilogue="squash", squash_dim=cfg.primary_dim),
                        LONG_SUM),
        "PrimaryCaps (SVHN)": (psv, wsv, svb, svpc,
                               dict(epilogue="squash",
                                    squash_dim=svcfg.primary_dim), LONG_SUM)}
    for label, (pp, ww, bb, blk, kw, tol) in gemm_sites.items():
        print(f"K2 {label}: [{pp.shape[0]}, {pp.shape[1]}] x "
              f"[{ww.shape[0]}, {ww.shape[1]}], tiles {blk.tiles}, split_k "
              f"{blk.split_k}, {blk.ctas} CTAs", flush=True)
        held("matmul_bias_act", f"K2 GEMM {label} {kw['epilogue']}",
             same_bits(f"K2 GEMM {label}", lambda: k12.gemm_tiles(
                 blk.tiles, pp, ww, bb, **kw)),
             k12.matmul_bias_act_plain(pp, ww, bb, split_k=blk.split_k,
                                       block_k=blk.block_k, **kw), tol)
    # K3 on the plans' clusters (the MNIST per-op ClassCaps, whose votes
    # fit a cluster CTA's rows, and the smoke config), and K4 with
    # streamed votes named (MNIST, on the planner's streamed cluster; the
    # smoke config with a ragged i-tile), each twice for identical bits
    # (their times are sites of K3's and K4's rows, phase 12).
    for label, uu, ww, op in (("MNIST per-op", u, wcc, vr),
                              ("smoke", su, swcc, svr)):
        print(f"K3 {label} batch {SLOTS}: clusters of {op.cluster} "
              f"({op.block.ctas} CTAs), {op.smem_bytes} B a CTA", flush=True)
        held("votes_routing_cluster", f"K3 votes_routing resident, {label}, "
             f"{op.cluster}-CTA clusters", same_bits(
                 f"K3 {label}", lambda: k34.votes_routing(
                     uu, ww, mode=op.mode, block_i=op.block_i,
                     cluster=op.cluster)),
             k3_twin(uu, ww, None, op.cluster, iters=3, num_classes=10),
             ROUTING)
    for label, uu, ww, bi in (("MNIST", u, wcc, mst.block_i),
                              ("smoke, ragged i", su, swcc, 24)):
        kw4 = dict(iters=3, num_classes=10, mode="streamed", block_i=bi)
        cs4 = k34.fwd_cluster(uu, ww, cluster=None, **kw4)
        print(f"K4 streamed {label} batch {SLOTS}: block_i {bi}, clusters "
              f"of {cs4}", flush=True)
        held("votes_routing_streamed_cluster", f"K4 votes_routing streamed, "
             f"{label}, {cs4}-CTA clusters", same_bits(
                 f"K4 {label}", lambda: k34.votes_routing(uu, ww, **kw4)),
             k34.cluster_routing_plain(uu, ww, cluster=cs4, **kw4), ROUTING)
    # K5 on the plan's cluster (MNIST at batch 8; batch 16 in phase 7), each
    # twice for identical bits.
    for (label, pp, wp, bp, ww, op) in (
            ("K5 primary_routing, MNIST batch 8", ppc, wpc, params["pc_b"],
             wcc, pr),
            ("K5 primary_routing, smoke", sppc, swpc, sparams["pc_b"], swcc,
             spr)):
        kw5 = dict(mode=op.mode, block_i=op.block_i, cluster=op.cluster)
        print(f"{label}: {op.mode} votes, clusters of {op.cluster} "
              f"({op.block.ctas} CTAs), {op.smem_bytes} B a CTA", flush=True)
        held("primary_routing", f"{label}, {op.mode}, {op.cluster}-CTA "
             f"clusters", same_bits(label, lambda: k5.primary_routing_patches(
                 pp, wp, bp, ww, **kw5)),
             k5.primary_routing_patches_plain(pp, wp, bp, ww, iters=3,
                                              num_classes=10, **kw5),
             ROUTING)
    assert (pr.mode, vr.mode) == ("resident", "resident") and vr.cluster > 1
    assert pr.cluster > 1 and splan.op(execplan.PIPE_NAME).mode == "resident"
    assert svr.mode == "resident" and svr.cluster in execplan.CLUSTER_SIZES

    # 4. Full-width forward on both plans against the plain forward.
    with torch.no_grad():
        ref_out = capsnet.forward(params, images, cfg, backend="torch",
                                  device=dev)
        launches = {}
        for label, p in (("pipelined", plan), ("per-op", perop)):
            build.reset_launch_counts()
            out = capsnet.forward(params, images, cfg, backend="kernels",
                                  plan=p, device=dev)
            torch.cuda.synchronize()
            launches[label] = build.launch_counts()
            print(f"forward {label}: launches {launches[label]}", flush=True)
            for key in ("class_caps", "lengths", "reconstruction"):
                check(f"forward {label} {key}", out[key], ref_out[key],
                      ROUTING)
            same_predictions(f"forward {label}", out["lengths"].cpu(),
                             ref_out["lengths"].cpu(), ROUTING[1])
    if launches["per-op"]["votes_routing_cluster_f32"] < 1 or \
            launches["per-op"]["matmul_bias_act_f32"] < 2:
        raise AssertionError("the per-op forward did not run its kernels")

    # 5. Serve seeded requests through the engine (the main path).
    reqs = [CapsRequest(rid=i, image=rng.random(
        (cfg.image_hw, cfg.image_hw, 1), np.float32))
        for i in range(N_REQUESTS)]
    engine = CapsuleEngine(params, cfg, slots=SLOTS, backend="kernels",
                           device=dev)
    build.reset_launch_counts()
    for r in reqs:
        engine.submit(r)
    done = engine.run()
    torch.cuda.synchronize()
    serve_launches = build.launch_counts()
    stats = engine.stats()
    print(f"serve: {json.dumps(stats)}", flush=True)
    print(f"serve: launches {serve_launches}", flush=True)
    if len(done) != N_REQUESTS or any(r.status != "ok" for r in done):
        raise AssertionError(f"serve: statuses "
                             f"{[r.status for r in done]}")
    fault_free("serve", stats)
    for sym in ("im2col_patches_f32", "matmul_bias_act_f32",
                "primary_routing_f32"):
        if serve_launches[sym] < 1:
            raise AssertionError(f"serve: {sym} was never launched")
    with torch.no_grad():
        all_imgs = torch.tensor(np.stack([r.image for r in reqs]),
                                device=dev)
        plain_len = torch.cat([
            capsnet.forward(params, all_imgs[i:i + SLOTS], cfg,
                            backend="torch", device=dev)["lengths"]
            for i in range(0, N_REQUESTS, SLOTS)]).cpu()
    by_rid = sorted(done, key=lambda r: r.rid)
    same_predictions("serve", torch.tensor(np.stack([r.lengths
                                                     for r in by_rid])),
                     plain_len, ROUTING[1])
    print(f"serve: {N_REQUESTS} requests ok, "
          f"{stats['requests_per_s']:.1f} req/s, mean latency "
          f"{stats['mean_latency_ms']:.2f} ms", flush=True)
    # The same requests through the engine on the per-op plan.
    engine_po = CapsuleEngine(params, cfg, slots=SLOTS, backend="kernels",
                              device=dev, plan=perop)
    for r in reqs:
        engine_po.submit(CapsRequest(rid=r.rid, image=r.image))
    done_po = engine_po.run()
    torch.cuda.synchronize()
    if len(done_po) != N_REQUESTS or any(r.status != "ok" for r in done_po):
        raise AssertionError("serve per-op: a request failed")
    same_predictions("serve per-op", torch.tensor(np.stack(
        [r.lengths for r in sorted(done_po, key=lambda r: r.rid)])),
        plain_len, ROUTING[1])
    stats_po = engine_po.stats()
    fault_free("serve per-op plan", stats_po)
    print(f"serve per-op plan: {N_REQUESTS} requests ok, "
          f"{stats_po['requests_per_s']:.1f} req/s, mean latency "
          f"{stats_po['mean_latency_ms']:.2f} ms", flush=True)
    # 5b. The hardened engine: shrink replans and faults on the card.
    degraded = degraded_serving(dev, params, cfg, reqs, plain_len, images)

    # 6. Each kernel's time at the engine's batch against its bound, after
    # the whole forward's on each plan.
    with torch.no_grad():
        fwd_ms = {label: time_ms(lambda p=p, b=b: capsnet.forward(
            params, images, cfg, backend=b, plan=p, device=dev))
            for label, p, b in (("kernels, pipelined plan", plan, "kernels"),
                                ("kernels, per-op plan", perop, "kernels"),
                                ("torch", None, "torch"))}
    print(f"forward ms at batch {SLOTS}: {json.dumps(fwd_ms)}", flush=True)
    with torch.no_grad():
        for label, p in (("pipelined", plan), ("per-op", perop)):
            split_ = device_breakdown(lambda p=p: capsnet.forward(
                params, images, cfg, backend="kernels", plan=p, device=dev))
            print(f"forward {label} device ms by kernel (batch {SLOTS}): "
                  f"{json.dumps(split_)}", flush=True)
    b_ = SLOTS
    i_, jd, c_, it = lay.in_caps, lay.jd, lay.in_dim, lay.iters
    x_nchw, x1_nchw = images.permute(0, 3, 1, 2), x1.permute(0, 3, 1, 2)
    w1_oihw = params["conv1_w"].permute(3, 2, 0, 1)
    wpc_oihw = params["pc_w"].permute(3, 2, 0, 1)
    n1, npc = cfg.conv1_channels, cfg.pc_channels
    kkpc = ppc.shape[2]
    svx1_nchw, svw_oihw = svx1.permute(0, 3, 1, 2), svw.permute(3, 2, 0, 1)

    def k2_site(label, path, lib):
        """A K2 site of ``gemm_sites``: the kernel on the plan's tiles and
        split, its split-order twin, ``lib`` (``F.conv2d``) and, timed
        beside it, ``torch.addmm`` (the same product, no epilogue)."""
        pp, ww, bb, blk, kw, _ = gemm_sites[label]
        (m_, k_), n_ = pp.shape, ww.shape[1]
        return (label, path,
                lambda: k12.gemm_tiles(blk.tiles, pp, ww, bb, **kw),
                lambda: k12.matmul_bias_act_plain(
                    pp, ww, bb, split_k=blk.split_k, block_k=blk.block_k,
                    **kw), lib,
                4.0 * (m_ * k_ + k_ * n_ + n_ + m_ * n_), 2.0 * m_ * k_ * n_,
                lambda row: gemm_extras(
                    row, lib, split_k=blk.split_k, ctas=blk.ctas,
                    addmm=lambda: torch.addmm(bb, pp, ww)))

    sites = {
        "im2col_patches": [k1_site(label, "main", xx, kk, ss)
                           for label, xx, kk, ss in (
                               ("Conv1", images, k1, 1),
                               ("PrimaryCaps", x1, kp, cfg.pc_stride))],
        "matmul_bias_act": [
            k2_site("Conv1", "main",
                    lambda: F.conv2d(x_nchw, w1_oihw, params["conv1_b"])),
            k2_site("PrimaryCaps", "per-op",
                    lambda: F.conv2d(x1_nchw, wpc_oihw, params["pc_b"],
                                     stride=cfg.pc_stride)),
            k2_site("PrimaryCaps (SVHN)", "svhn",
                    lambda: F.conv2d(svx1_nchw, svw_oihw, svb,
                                     stride=svcfg.pc_stride))],
        "primary_routing": [
            (execplan.PIPE_NAME + " (MNIST, 8)", "main",
             lambda: k5.primary_routing_patches(
                 ppc, wpc, params["pc_b"], wcc, mode=pr.mode,
                 block_i=pr.block_i, cluster=pr.cluster),
             lambda: k5.primary_routing_patches_plain(
                 ppc, wpc, params["pc_b"], wcc, iters=it,
                 num_classes=lay.num_caps, mode=pr.mode, block_i=pr.block_i,
                 cluster=pr.cluster),
             None,
             4.0 * (ppc.numel() + wpc.numel() + npc + wcc.numel() + b_ * jd),
             2.0 * mpc * kkpc * npc + routing_flops(b_, i_, c_, jd, it))],
    }
    meta = {
        "im2col_patches": ("conv_im2col.cu",
                           "src/repro/kernels/conv_im2col.py:54", "main"),
        "matmul_bias_act": ("conv_im2col.cu",
                            "src/repro/kernels/conv_im2col.py:150", "main"),
        "primary_routing": ("primary_routing.cu",
                            "src/repro/kernels/primary_routing.py:132",
                            "main"),
    }
    rows = []
    for kernel, kernel_sites in sites.items():
        source, replaces, path = meta[kernel]
        site_rows = []
        for (op, on, fn, plain, lib, nbytes, flops, *extra) in kernel_sites:
            bms, by = bound(nbytes, flops)
            site_rows.append(dict(
                op=op, path=on, ms=time_ms(fn), device_ms=device_ms(fn),
                plain_ms=time_ms(plain),
                library_ms=time_ms(lib) if lib is not None else None,
                bound_ms=bms, bound_by=by, bytes=nbytes, flops=flops))
            if extra:
                site_rows[-1].update(extra[0](site_rows[-1]))
        main = [s for s in site_rows if s["path"] == path]
        counts = serve_launches if path == "main" else launches["per-op"]
        libs = [s["library_ms"] for s in main]
        t_bytes = sum(s["bytes"] for s in main) / PEAK_HBM_BYTES * 1e3
        t_ops = sum(s["flops"] for s in main) / PEAK_FP32_FLOPS * 1e3
        rows.append(dict(
            name=kernel, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{source}",
            replaces=replaces,
            launches=counts[f"{kernel}_f32"],
            max_abs_err=errs[kernel],
            ms=sum(s["ms"] for s in main),
            device_ms=summed(s["device_ms"] for s in main),
            plain_ms=sum(s["plain_ms"] for s in main),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=(sum(libs) if all(x is not None for x in libs)
                        else None),
            path=("serve, pipelined plan" if path == "main"
                  else "forward, per-op plan"),
            sites=site_rows))

    # K2's split of K at the PrimaryCaps sites: the plan's, half and twice
    # it, and none (one CTA per tile, as the TPU's grid walked K); device
    # ms, the plan's pick beside the splits it passed over.
    k2_row = next(r for r in rows if r["name"] == "matmul_bias_act")
    k2_row["split_sweep"] = {}
    for label in ("PrimaryCaps", "PrimaryCaps (SVHN)"):
        pp, ww, bb, blk, kw, _ = gemm_sites[label]
        tiles = blk.ctas // blk.split_k
        for want in sorted({1, max(1, blk.split_k // 2), blk.split_k,
                            2 * blk.split_k}):
            split = planner.split_slab(pp.shape[1], want, blk.block_k)[0]
            t = device_ms(lambda split=split: k12.gemm_tiles(
                blk.tiles[:3] + (split,), pp, ww, bb, **kw), reps=5)
            k2_row["split_sweep"][f"{label} split_k {split}"] = t
            print(f"K2 {label} split_k {split} ({tiles * split} CTAs"
                  f"{', the plan' if split == blk.split_k else ''}): "
                  f"device {t} ms", flush=True)

    # K5's cluster size at MNIST batch 8: the plan's among every size.
    k5_row = next(r for r in rows if r["name"] == "primary_routing")
    k5_row.update(cluster=pr.cluster, ctas=pr.block.ctas, mode=pr.mode)

    def k5_plan_at(cs, pp=ppc, c=cfg, ly=lay):
        try:
            return execplan.plan_primary_routing(
                pp.shape[1], pp.shape[2], c.pc_channels, ly.in_caps,
                ly.in_dim, ly.jd, ly.num_caps, batch=pp.shape[0], cluster=cs)
        except execplan.PlanError:
            return None

    def k5_occupancy(sched, cs, c=cfg, ly=lay, pp=ppc):
        return k5.occupancy(pp.shape[1], c.pc_channels, c.primary_dim,
                            ly.num_caps, ly.caps_dim, mode=sched.mode,
                            block_i=sched.block_i, cluster=cs)

    k5_row["cluster_sweep"] = {"MNIST, 8": cluster_sweep(
        "K5 MNIST batch 8", k5_plan_at,
        lambda sc, cs: k5.primary_routing_patches(
            ppc, wpc, params["pc_b"], wcc, mode=sc.mode,
            block_i=sc.block_i, cluster=cs), k5_occupancy)}
    sweep_miss("K5 MNIST batch 8", k5_row["cluster_sweep"]["MNIST, 8"],
               pr.cluster)
    # And at the smoke config (the plan's size there follows the cluster
    # model fitted to K3's and K8's sweeps as well).
    print(f"K5 smoke batch {SLOTS}: the plan's clusters of {spr.cluster}",
          flush=True)
    k5_row["cluster_sweep"]["smoke, 8"] = cluster_sweep(
        f"K5 smoke batch {SLOTS}",
        lambda cs: k5_plan_at(cs, pp=sppc, c=smoke, ly=slay),
        lambda sc, cs: k5.primary_routing_patches(
            sppc, swpc, sparams["pc_b"], swcc, mode=sc.mode,
            block_i=sc.block_i, cluster=cs),
        lambda sc, cs: k5_occupancy(sc, cs, c=smoke, ly=slay, pp=sppc))
    sweep_miss(f"K5 smoke batch {SLOTS}", k5_row["cluster_sweep"]["smoke, 8"],
               spr.cluster)

    # 7. The backward kernels against their twins at the training shapes.
    tb = TRAIN_BATCH
    timages = torch.tensor(
        rng.random((tb, cfg.image_hw, cfg.image_hw, 1), np.float32),
        device=dev)
    tx1, tu = conv_inputs(cfg, params, timages)
    tp1 = k12.im2col_patches_plain(timages, kh=k1, kw=k1)
    tppc = k12.im2col_patches_plain(tx1, kh=kp, kw=kp, stride=cfg.pc_stride)
    tm1, tmpc = tp1.shape[0] * tp1.shape[1], tppc.shape[0] * tppc.shape[1]
    a1, apc = tp1.reshape(tm1, -1), tppc.reshape(tmpc, -1)

    def randn(*shape, scale=1.0):
        return torch.tensor(scale * rng.standard_normal(shape, np.float32),
                            device=dev)

    dpre1 = randn(tm1, cfg.conv1_channels, scale=1e-3)
    dprepc = randn(tmpc, cfg.pc_channels, scale=1e-3)
    npc_ = cfg.pc_channels
    dpatch = randn(tb, tppc.shape[1], tppc.shape[2], scale=1e-3)
    g = randn(tb, lay.jd, scale=1e-2)
    su16 = conv_inputs(smoke, sparams, torch.tensor(
        rng.random((tb, smoke.image_hw, smoke.image_hw, 1), np.float32),
        device=dev))[1]
    sg = randn(tb, slay.jd, scale=1e-2)
    tplan = execplan.compile_plan(cfg, batch=tb, pipeline=True, train=True)
    tperop = execplan.compile_plan(cfg, batch=tb, pipeline=False, train=True)
    vbwd = tplan.op(execplan.FUSED_NAME + execplan.BWD_SUFFIX)
    sbwd = execplan.compile_plan(smoke, batch=tb, train=True).op(
        execplan.FUSED_NAME + execplan.BWD_SUFFIX)
    assert vbwd.cluster > 1 and sbwd.mode == "resident"
    assert sbwd.cluster in execplan.CLUSTER_SIZES
    for name, p in (("MNIST pipelined train", tplan),
                    ("MNIST per-op train", tperop)):
        print(f"plan {name}: {json.dumps(p.summary())}", flush=True)
    h, w_ = cfg.conv1_out, cfg.conv1_out
    berrs: dict[str, float] = {}

    def held_scaled(kernel, name, got, want, tol):
        if isinstance(got, tuple):
            err = max(check_scaled(f"{name} {part}", x, y, tol)
                      for part, x, y in zip(("du", "dW"), got, want))
        else:
            err = check_scaled(name, got, want, tol)
        berrs[kernel] = max(berrs.get(kernel, 0.0), err)

    for label, aa, dd in (("PrimaryCaps", apc, dprepc), ("Conv1", a1, dpre1)):
        held_scaled("matmul_at_b", f"K6 dW {label}",
                    same_bits(f"K6 dW {label}",
                              lambda aa=aa, dd=dd: k12.matmul_at_b(aa, dd)),
                    k12.matmul_at_b_plain(aa, dd), AT_B_SUM)
    # The dpatches GEMM (K2 on the training plan's dx tiles): dpre W^T.
    dxb = tperop.bwd_op("PrimaryCaps").dx_block
    wpc_t = wpc.t().contiguous()
    zero_k = torch.zeros(wpc.shape[0], device=dev)
    print(f"K2 dpatches: [{tmpc}, {npc_}] x [{npc_}, {wpc.shape[0]}], tiles "
          f"{dxb.tiles}, split_k {dxb.split_k}, {dxb.ctas} CTAs", flush=True)
    held_scaled("matmul_bias_act", "K2 dpatches PrimaryCaps-bwd",
                same_bits("K2 dpatches", lambda: k12.gemm_tiles(
                    dxb.tiles, dprepc, wpc_t, zero_k)),
                k12.matmul_bias_act_plain(dprepc, wpc_t, zero_k,
                                          split_k=dxb.split_k,
                                          block_k=dxb.block_k), DPATCHES)
    col_kw = dict(kh=kp, kw=kp, stride=cfg.pc_stride, h=h, w=w_)
    r = check("K7 col2im PrimaryCaps", same_bits(
        "K7 PrimaryCaps", lambda: k12.col2im_patches(dpatch, **col_kw)),
        k12.col2im_patches_plain(dpatch, **col_kw), EXACT)
    berrs["col2im_patches"] = r["max_abs"]
    print(f"K9 MNIST batch {tb}: {vbwd.mode} votes, clusters of "
          f"{vbwd.cluster} ({vbwd.block.ctas} CTAs), {vbwd.smem_bytes} B a "
          f"CTA", flush=True)
    for label, kern, uu, ww, gg, mode, bi, cs in (
            ("K9 routing bwd, MNIST batch 16", "routing_bwd_cluster", tu,
             wcc, g, vbwd.mode, vbwd.block_i, vbwd.cluster),
            ("K9 routing bwd, smoke, 16-CTA clusters, ragged blocks",
             "routing_bwd_cluster", su16, swcc, sg, "streamed", 3, 16),
            ("K9 routing bwd, smoke, 1-CTA clusters, ragged blocks",
             "routing_bwd_cluster", su16, swcc, sg, "streamed", 24, 1),
            (f"K8 routing bwd resident, smoke, {sbwd.cluster}-CTA clusters",
             "routing_bwd_cluster", su16, swcc, sg, sbwd.mode, sbwd.block_i,
             sbwd.cluster)):
        kw = dict(iters=3, num_classes=10, mode=mode, block_i=bi, cluster=cs)
        held_scaled(kern, label, same_bits(label, lambda: (
            k34.votes_routing_bwd(uu, ww, gg, **kw))),
            k34.votes_routing_bwd_plain(uu, ww, gg, **kw), GRAD)
    # K5 at the training plan's batch and cluster.
    tpr = tplan.op(execplan.PIPE_NAME)
    kw5 = dict(mode=tpr.mode, block_i=tpr.block_i, cluster=tpr.cluster)
    print(f"K5 MNIST batch {tb}: {tpr.mode} votes, clusters of "
          f"{tpr.cluster} ({tpr.block.ctas} CTAs)", flush=True)
    r = check(f"K5 primary_routing, MNIST batch {tb}, {tpr.mode}, "
              f"{tpr.cluster}-CTA clusters",
              same_bits(f"K5 MNIST batch {tb}",
                        lambda: k5.primary_routing_patches(
                            tppc, wpc, params["pc_b"], wcc, **kw5)),
              k5.primary_routing_patches_plain(tppc, wpc, params["pc_b"],
                                               wcc, iters=3, num_classes=10,
                                               **kw5), ROUTING)
    errs["primary_routing"] = max(errs["primary_routing"], r["max_abs"])

    # 8. One full-width total_loss backward on both training plans against
    # the plain backend's autograd gradients.
    labels = torch.tensor(rng.integers(0, cfg.num_classes, tb), device=dev)
    want, _ = capsnet.loss_and_grads(params, timages, labels, cfg,
                                     backend="torch", device=dev)
    bwd_launches = {}
    for label, p in (("pipelined", tplan), ("per-op", tperop)):
        build.reset_launch_counts()
        got, _ = capsnet.loss_and_grads(params, timages, labels, cfg,
                                        backend="kernels", plan=p,
                                        device=dev)
        torch.cuda.synchronize()
        bwd_launches[label] = build.launch_counts()
        print(f"backward {label}: launches {bwd_launches[label]}",
              flush=True)
        for k in params:               # loss_and_grads refuses a None grad
            check_scaled(f"backward {label} d{k}", got[k], want[k], GRAD)
        for sym in ("matmul_at_b_f32", "col2im_patches_f32",
                    "routing_bwd_cluster_f32"):
            if bwd_launches[label][sym] < 1:
                raise AssertionError(f"backward {label}: {sym} was never "
                                     f"launched")

    # 9. Train: the full-width network (this slice's main path), then the
    # CLI's default smoke config (the resident backward, K8, on a cluster).
    train_launches, train_ms = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, tcfg, steps, pipe in (
                ("mnist", cfg, TRAIN_STEPS, True),
                ("mnist per-op", cfg, TRAIN_STEPS, False),
                ("smoke", capsnet_loop.SMOKE, 4, True)):
            loop = capsnet_loop.CapsTrainLoop(tcfg, capsnet_loop.CapsLoopConfig(
                total_steps=steps, batch=tb, ckpt_every=10,
                ckpt_dir=str(Path(tmp) / label), log_every=5, seed=SEED),
                device=dev)
            if not pipe:
                loop.plan = execplan.compile_plan(tcfg, batch=tb, train=True,
                                                  pipeline=False)
            build.reset_launch_counts()
            hist = loop.run(resume=False)
            torch.cuda.synchronize()
            train_launches[label] = build.launch_counts()
            train_ms[label] = 1e3 * statistics.median(
                h["time_s"] for h in hist)
            losses = [h["loss"] for h in hist]
            print(f"train {label}: {steps} SGD steps at batch {tb}, loss "
                  f"{losses[0]:.4f} -> {losses[-1]:.4f}, median step "
                  f"{train_ms[label]:.2f} ms, launches "
                  f"{train_launches[label]}", flush=True)
            if len(hist) != steps or (
                    label != "smoke"
                    and not capsnet_loop.improved(hist, loop.nan_skips)):
                raise AssertionError(f"train {label}: the loss did not "
                                     f"fall, or a rollback fired")
    main_counts = train_launches["mnist"]
    for sym in ("im2col_patches_f32", "matmul_bias_act_f32",
                "primary_routing_f32", "matmul_at_b_f32",
                "col2im_patches_f32", "routing_bwd_cluster_f32"):
        if main_counts[sym] < TRAIN_STEPS:
            raise AssertionError(f"train mnist: {sym} ran "
                                 f"{main_counts[sym]} times")
    if train_launches["mnist per-op"]["routing_bwd_cluster_f32"] < \
            TRAIN_STEPS:
        raise AssertionError("train mnist per-op: K9 did not run each step")
    if train_launches["smoke"]["routing_bwd_cluster_f32"] < 4:
        raise AssertionError("train smoke: K8 did not run each step")

    # 10. The backward kernels' times at the training shapes.
    jd_, c_, i_ = lay.jd, lay.in_dim, lay.in_caps
    fold_in = fold_input(dpatch, kp, kp)
    bwd_sites = [
        ("matmul_at_b", "conv_bwd.cu", "src/repro/kernels/conv_im2col.py:226",
         [("PrimaryCaps-bwd",
           lambda: k12.matmul_at_b(apc, dprepc),
           lambda: k12.matmul_at_b_plain(apc, dprepc),
           lambda: torch.matmul(apc.t(), dprepc),
           4.0 * (apc.numel() + dprepc.numel() + apc.shape[1] * npc),
           2.0 * tmpc * apc.shape[1] * npc, tmpc, apc.shape[1], npc),
          ("Conv1-bwd",
           lambda: k12.matmul_at_b(a1, dpre1),
           lambda: k12.matmul_at_b_plain(a1, dpre1),
           lambda: torch.matmul(a1.t(), dpre1),
           4.0 * (a1.numel() + dpre1.numel() + a1.shape[1] * n1),
           2.0 * tm1 * a1.shape[1] * n1, tm1, a1.shape[1], n1)]),
        ("col2im_patches", "conv_bwd.cu",
         "src/repro/kernels/conv_im2col.py:275",
         [("PrimaryCaps-bwd",
           lambda: k12.col2im_patches(dpatch, **col_kw),
           lambda: k12.col2im_patches_plain(dpatch, **col_kw),
           lambda: F.fold(fold_in, output_size=(h, w_), kernel_size=kp,
                          stride=cfg.pc_stride),
           4.0 * (dpatch.numel() + tx1.numel()), float(dpatch.numel()))]),
        ("routing_bwd_cluster", "votes_routing_bwd.cu",
         "src/repro/kernels/votes_routing.py:367 (K9); "
         "src/repro/kernels/votes_routing.py:273 (K8)",
         [("ClassCaps-Routing-bwd (MNIST, 16)",
           lambda: k34.votes_routing_bwd(tu, wcc, g, mode=vbwd.mode,
                                         block_i=vbwd.block_i,
                                         cluster=vbwd.cluster),
           lambda: k34.votes_routing_bwd_plain(
               tu, wcc, g, iters=3, num_classes=10, mode=vbwd.mode,
               block_i=vbwd.block_i, cluster=vbwd.cluster), None,
           routing_bwd_bytes(tu, wcc),
           routing_bwd_flops(tb, i_, c_, jd_, 3))]),
    ]
    for kernel, source, replaces, kernel_sites in bwd_sites:
        site_rows = []
        for (op, fn, plain, lib, nbytes, flops, *shape) in kernel_sites:
            bms, by = bound(nbytes, flops)
            site_rows.append(dict(
                op=op, ms=time_ms(fn), device_ms=device_ms(fn),
                plain_ms=time_ms(plain),
                library_ms=time_ms(lib) if lib is not None else None,
                bound_ms=bms, bound_by=by, bytes=nbytes, flops=flops))
            if shape:                  # K6: its split of M and its grid
                sched = planner.at_b_plan(*shape)
                site_rows[-1].update(splits=sched.splits, rows=sched.rows,
                                     wide_rows=sched.wide_rows,
                                     ctas=sched.ctas,
                                     library_device_ms=device_ms(lib))
                print(f"K6 {op}: {sched}, device "
                      f"{site_rows[-1]['device_ms']} ms (bound {bms:.4f}); "
                      f"torch.matmul {site_rows[-1]['library_device_ms']} "
                      f"ms device", flush=True)
        libs = [s_["library_ms"] for s_ in site_rows]
        t_bytes = sum(s_["bytes"] for s_ in site_rows) / PEAK_HBM_BYTES * 1e3
        t_ops = sum(s_["flops"] for s_ in site_rows) / PEAK_FP32_FLOPS * 1e3
        launches_ = main_counts[f"{kernel}_f32"]
        rows.append(dict(
            name=kernel, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{source}",
            replaces=replaces, launches=launches_,
            launches_per_step=launches_ / TRAIN_STEPS,
            max_abs_err=berrs[kernel],
            ms=sum(s_["ms"] for s_ in site_rows),
            device_ms=summed(s_["device_ms"] for s_ in site_rows),
            plain_ms=sum(s_["plain_ms"] for s_ in site_rows),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=(sum(libs) if all(x is not None for x in libs)
                        else None),
            path="train, MNIST full width, pipelined train plan",
            sites=site_rows))
    # K7's cold-L2 time and F.fold's device time (F.fold's input is
    # permuted to its layout before timing; the permute is not timed).
    k7_site = next(r for r in rows if r["name"] == "col2im_patches")[
        "sites"][0]
    k7_site.update(gather_extras(
        k7_site, lambda: k12.col2im_patches(dpatch, **col_kw),
        lambda: F.fold(fold_in, output_size=(h, w_), kernel_size=kp,
                       stride=cfg.pc_stride), "col2im_kernel"))
    # K9: its cluster, the replay and the emit apart, and every cluster
    # size at batch 16.
    k9_row = next(r for r in rows if r["name"] == "routing_bwd_cluster")
    k9_row.update(cluster=vbwd.cluster, ctas=vbwd.block.ctas,
                  mode=vbwd.mode)

    k9_row["sites"][0].update(replay_emit_ms(
        lambda: k34.votes_routing_bwd(tu, wcc, g, mode=vbwd.mode,
                                      block_i=vbwd.block_i,
                                      cluster=vbwd.cluster)))
    print(f"K9 MNIST batch {tb}: replay "
          f"{k9_row['sites'][0]['replay_device_ms']} ms, emit "
          f"{k9_row['sites'][0]['emit_device_ms']} ms (device)", flush=True)
    # K8 (resident votes, the same kernel) at the CLI smoke config: a site
    # of the row, outside the MNIST path's totals (SVHN's in phase 12).
    k9_row["sites"] += timed_sites([(
        f"ClassCaps-Routing-bwd (K8, smoke, {tb})",
        lambda: k34.votes_routing_bwd(su16, swcc, sg, mode=sbwd.mode,
                                      block_i=sbwd.block_i,
                                      cluster=sbwd.cluster),
        lambda: k34.votes_routing_bwd_plain(
            su16, swcc, sg, iters=3, num_classes=10, mode=sbwd.mode,
            block_i=sbwd.block_i, cluster=sbwd.cluster), None,
        routing_bwd_bytes(su16, swcc),
        routing_bwd_flops(tb, slay.in_caps, slay.in_dim, slay.jd, 3))])
    k9_row["sites"][-1].update(
        cluster=sbwd.cluster, launches_smoke_train=train_launches["smoke"][
            "routing_bwd_cluster_f32"])

    def k9_plan_at(cs, ly=lay, b=tb):
        return execplan.plan_routing_bwd_cluster(
            ly.in_caps, ly.in_dim, ly.jd, ly.num_caps, batch=b, cluster=cs)

    def k9_occupancy(sched, cs, ly=lay):
        return k34.bwd_cluster_occupancy(
            ly.in_caps, ly.in_dim, ly.num_caps, ly.caps_dim,
            mode=sched.mode, block_i=sched.block_i, cluster=cs)

    k9_row["cluster_sweep"] = {"MNIST, 16": cluster_sweep(
        f"K9 MNIST batch {tb}", k9_plan_at,
        lambda sc, cs: k34.votes_routing_bwd(
            tu, wcc, g, iters=3, num_classes=10, mode=sc.mode,
            block_i=sc.block_i, cluster=cs), k9_occupancy)}
    sweep_miss(f"K9 MNIST batch {tb}", k9_row["cluster_sweep"]["MNIST, 16"],
               vbwd.cluster)
    # The dpatches GEMM, a site of K2's row on the training path.
    k2_row = next(r for r in rows if r["name"] == "matmul_bias_act")
    kpc = wpc.shape[0]
    dsite = timed_sites([(
        "PrimaryCaps-bwd dpatches (16)",
        lambda: k12.gemm_tiles(dxb.tiles, dprepc, wpc_t, zero_k),
        lambda: k12.matmul_bias_act_plain(dprepc, wpc_t, zero_k,
                                          split_k=dxb.split_k,
                                          block_k=dxb.block_k),
        lambda: torch.addmm(zero_k, dprepc, wpc_t),
        4.0 * (tmpc * npc + npc * kpc + kpc + tmpc * kpc),
        2.0 * tmpc * npc * kpc)])[0]
    dsite.update(path="train", split_k=dxb.split_k, ctas=dxb.ctas,
                 library_device_ms=device_ms(
                     lambda: torch.addmm(zero_k, dprepc, wpc_t)))
    print(f"K2 dpatches: split_k {dxb.split_k}, {dxb.ctas} CTAs, device "
          f"{dsite['device_ms']} ms (bound {dsite['bound_ms']:.4f}); addmm "
          f"{dsite['library_device_ms']} ms device", flush=True)
    k2_row["sites"].append(dsite)
    # K6's schedule at the PrimaryCaps dW: the plan's against every tile
    # 128 x 128 (one CTA per tile over all of M, the TPU grid's shape).
    k6_row = next(r for r in rows if r["name"] == "matmul_at_b")
    sched = planner.at_b_plan(tmpc, kpc, npc)
    assert sched.splits == 1, sched
    out_ = torch.empty(kpc, npc, device=dev)
    k6_row["schedule_sweep"] = {}
    for label, wide in (("the plan", sched.wide_rows),
                        ("128 x 128 tiles only", kpc)):
        t = device_ms(lambda wide=wide: k12.AT_B(
            build.ptr(apc), build.ptr(dprepc), build.ptr(out_),
            build.ptr(out_), tmpc, kpc, npc, 1, sched.rows, wide,
            build.stream_of(apc)), reps=10)
        k6_row["schedule_sweep"][label] = dict(wide_rows=wide, device_ms=t)
        print(f"K6 PrimaryCaps dW, {label} (wide rows {wide} of {kpc}): "
              f"device {t} ms", flush=True)
    k2_row["max_abs_err"] = max(k2_row["max_abs_err"],
                                berrs["matmul_bias_act"])
    print(f"train ms per step at batch {tb}: {json.dumps(train_ms)}",
          flush=True)

    # 11. The split ClassCaps path (K14a caps_votes writes u_hat to device
    # memory, K14b routing reads it back: the paper's baseline) against
    # the fused ClassCaps (K3 on the per-op plan), and the standalone
    # squash (K10) with its VJP.  u is
    # the per-op plan's PrimaryCaps output, W the routing weights.
    with torch.no_grad():
        x_pre = ops.conv2d(x1, params["pc_w"], params["pc_b"],
                           stride=cfg.pc_stride)       # no squash epilogue
        u_pc = ops.conv2d(x1, params["pc_w"], params["pc_b"],
                          stride=cfg.pc_stride, plan_op=perop.op(
                              "PrimaryCaps"), squash_dim=cfg.primary_dim)
    x_pre = x_pre.reshape(b_, i_, c_)
    u_pc = u_pc.reshape(b_, i_, c_)
    rows_pc = x_pre.reshape(-1, c_)                       # [8 * 1152, 8]
    x_wide = randn(4096, 256)               # benchmarks/bench_kernels.py
    g_pc, g_wide = randn(*rows_pc.shape), randn(*x_wide.shape)
    wide_cfg = capsnet.CapsNetConfig(     # no GEMM tile holds 160 floats
        image_hw=14, conv1_channels=24, conv1_kernel=5, pc_kernel=3,
        num_primary_groups=1, primary_dim=160, class_dim=8,
        decoder_hidden=(32, 64))
    wide_params = capsnet.init_params(torch.Generator().manual_seed(SEED + 2),
                                      wide_cfg, device=dev)
    wide_images = torch.tensor(rng.random((SLOTS, 14, 14, 1), np.float32),
                               device=dev)
    wide_labels = torch.tensor(rng.integers(0, 10, SLOTS), device=dev)
    wide_plan = execplan.compile_plan(wide_cfg, batch=SLOTS, pipeline=False,
                                      train=True)
    assert not wide_plan.op("PrimaryCaps").fuses_squash
    cv_bi = ops.planned_block_i(i_, c_, jd, b_)
    cv_grid = execplan.caps_votes_grid(i_, jd, cv_bi)
    rt_mode, rt_bi, rt_cs = ops.planned_routing(i_, lay.num_caps, jd, it, b_)
    rt_kw = dict(iters=it, num_classes=lay.num_caps, mode=rt_mode,
                 block_i=rt_bi, cluster=rt_cs)
    rt_smem = execplan.routing_split_cluster_smem(rt_mode, i_, rt_bi,
                                                  lay.num_caps, jd, rt_cs)
    sq_rows = perop.op("PrimaryCaps").block_rows
    wide_rows = execplan.squash_block_rows(x_wide.shape[1], x_wide.shape[0])
    sq_grid = execplan.squash_grid(rows_pc.shape[0], sq_rows,
                                   execplan.squash_lanes(c_))
    wide_grid = execplan.squash_grid(x_wide.shape[0], wide_rows,
                                     execplan.squash_lanes(x_wide.shape[1]))
    print(f"split plan: caps_votes block_i {cv_bi} ({cv_grid[0]} CTAs of "
          f"{cv_grid[1]} threads), routing {rt_mode} rows, block_i "
          f"{rt_bi}, clusters of {rt_cs} ({b_ * rt_cs} CTAs, {rt_smem} B a "
          f"CTA), squash block_rows {sq_rows} (D={c_}, "
          f"{execplan.squash_lanes(c_)} lanes a row: {sq_grid[0]} CTAs of "
          f"{sq_grid[1]} threads) / {wide_rows} (D=256: {wide_grid[0]} CTAs "
          f"of {wide_grid[1]})", flush=True)

    # The path, with the counts at 0: the split path at full width, the
    # standalone squash and its backward on the PrimaryCaps capsules, and
    # one gradient of a network whose capsule cannot fuse (the per-op
    # plan runs K10 after the plain GEMM).
    build.reset_launch_counts()
    with torch.no_grad():
        u_hat = ops.caps_votes(u_pc, wcc, plan=perop)
        v_split = ops.routing(u_hat, plan=perop)
    xs = rows_pc.detach().clone().requires_grad_()
    ops.squash(xs, plan=perop).backward(g_pc)
    wide_got, _ = capsnet.loss_and_grads(
        wide_params, wide_images, wide_labels, wide_cfg, backend="kernels",
        plan=wide_plan, device=dev)
    torch.cuda.synchronize()
    split_launches = build.launch_counts()
    print(f"split: launches {split_launches}", flush=True)
    for sym in ("caps_votes_f32", "routing_cluster_f32", "squash_f32",
                "squash_bwd_f32"):
        if split_launches[sym] < 1:
            raise AssertionError(f"split: {sym} was never launched")

    # What came out, against the plain twins and the fused kernel.
    with torch.no_grad():
        v_fused = ops.votes_routing(u_pc, wcc, plan=perop)
        held("caps_votes", "K14a caps_votes MNIST", u_hat,
             k14a.caps_votes_plain(u_pc, wcc, block_i=cv_bi), FMA_CHAIN)
        held("caps_votes", "K14a caps_votes MNIST, block_i 7 (ragged)",
             k14a.caps_votes(u_pc, wcc, block_i=7),
             k14a.caps_votes_plain(u_pc, wcc, block_i=7), FMA_CHAIN)
        # K14b on the plan's cluster, and streamed in ragged tiles of 100
        # rows (on 2-CTA clusters: 576 rows a CTA), each twice for
        # identical bits.
        held("routing_cluster", f"K14b routing MNIST, {rt_mode} rows, "
             f"{rt_cs}-CTA clusters", v_split, k14b.routing_plain(
                 u_hat, **rt_kw), SPLIT)
        same_bits("K14b MNIST", lambda: k14b.routing(u_hat, **rt_kw))
        rg_kw = dict(iters=it, num_classes=lay.num_caps, mode="streamed",
                     block_i=100, cluster=2)
        held("routing_cluster", "K14b routing MNIST, streamed block_i 100 "
             "(ragged), 2-CTA clusters", same_bits(
                 "K14b MNIST ragged", lambda: k14b.routing(u_hat, **rg_kw)),
             k14b.routing_plain(u_hat, **rg_kw), SPLIT)
        check("split v against the fused ClassCaps v (K3)", v_split, v_fused,
              SPLIT)
        lengths = [torch.linalg.vector_norm(
            v.reshape(b_, lay.num_caps, lay.caps_dim), dim=-1).cpu()
            for v in (v_split, v_fused)]
        same_predictions("split against fused", *lengths, SPLIT[1])
        held("squash", "K10 squash [9216, 8]",
             k10.squash_rows(rows_pc, block_rows=sq_rows),
             k10.squash_plain(rows_pc), SQUASH)
        held("squash", "K10 squash [4096, 256]",
             k10.squash_rows(x_wide, block_rows=wide_rows),
             k10.squash_plain(x_wide), SQUASH)
        held("squash_bwd", "K10 squash backward (autograd) [9216, 8]",
             xs.grad, k10.squash_bwd_plain(rows_pc, g_pc), SQUASH)
        held("squash_bwd", "K10 squash backward [4096, 256]",
             k10.squash_bwd(x_wide, g_wide, block_rows=wide_rows),
             k10.squash_bwd_plain(x_wide, g_wide), SQUASH)
    wide_want, _ = capsnet.loss_and_grads(
        wide_params, wide_images, wide_labels, wide_cfg, backend="torch",
        device=dev)
    for k in wide_params:
        check_scaled(f"unfused-squash network d{k}", wide_got[k],
                     wide_want[k], GRAD)

    # Times: each kernel against its twin, its bound and a library call
    # (device time too), with the L2 warm and cold, beside an empty launch
    # of its grid; then the split path against the fused kernel, with the
    # modeled global bytes of each.  A site is (op, kernel, plain,
    # library, bytes, flops, grid: (CTAs, threads) of a plain launch).
    n_uh = b_ * i_ * jd
    split_sites = [
        ("caps_votes", "caps_votes.cu", "src/repro/kernels/caps_votes.py:32",
         [("ClassCaps-FC (split)",
           lambda: k14a.caps_votes(u_pc, wcc, block_i=cv_bi),
           lambda: k14a.caps_votes_plain(u_pc, wcc, block_i=cv_bi),
           lambda: torch.einsum("bic,inc->bin", u_pc, wcc),
           4.0 * (u_pc.numel() + wcc.numel() + n_uh), 2.0 * n_uh * c_,
           cv_grid)]),
        ("routing_cluster", "routing.cu", "src/repro/kernels/routing.py:34",
         [("Sum+Squash / Update+Sum (split)",
           lambda: k14b.routing(u_hat, **rt_kw),
           lambda: k14b.routing_plain(u_hat, **rt_kw), None,
           4.0 * (n_uh + b_ * jd), 2.0 * n_uh * (2 * it + 1), None)]),
        ("squash", "squash.cu", "src/repro/kernels/squash.py:24",
         [("PrimaryCaps capsules [9216, 8]",
           lambda: k10.squash_rows(rows_pc, block_rows=sq_rows),
           lambda: k10.squash_plain(rows_pc), None,
           4.0 * 2 * rows_pc.numel(), 4.0 * rows_pc.numel(), sq_grid),
          ("[4096, 256]",
           lambda: k10.squash_rows(x_wide, block_rows=wide_rows),
           lambda: k10.squash_plain(x_wide), None,
           4.0 * 2 * x_wide.numel(), 4.0 * x_wide.numel(), wide_grid)]),
        ("squash_bwd", "squash.cu", "src/repro/kernels/squash.py:29",
         [("PrimaryCaps capsules [9216, 8]",
           lambda: k10.squash_bwd(rows_pc, g_pc, block_rows=sq_rows),
           lambda: k10.squash_bwd_plain(rows_pc, g_pc), None,
           4.0 * 3 * rows_pc.numel(), 8.0 * rows_pc.numel(), sq_grid),
          ("[4096, 256]",
           lambda: k10.squash_bwd(x_wide, g_wide, block_rows=wide_rows),
           lambda: k10.squash_bwd_plain(x_wide, g_wide), None,
           4.0 * 3 * x_wide.numel(), 8.0 * x_wide.numel(), wide_grid)]),
    ]
    with torch.no_grad():
        for kernel, source, replaces, kernel_sites in split_sites:
            site_rows = []
            for (op, fn, plain, lib, nbytes, flops, grid) in kernel_sites:
                bms, by = bound(nbytes, flops)
                row = dict(
                    op=op, ms=time_ms(fn), device_ms=device_ms(fn),
                    cold_device_ms=cold_device_ms(
                        fn, kernel.removesuffix("_bwd")),
                    plain_ms=time_ms(plain),
                    library_ms=time_ms(lib) if lib is not None else None,
                    library_device_ms=(device_ms(lib) if lib is not None
                                       else None),
                    bound_ms=bms, bound_by=by, bytes=nbytes, flops=flops)
                if grid is not None:
                    row["empty_launch"] = grid_floor(*grid)
                    print_site(kernel, row)
                site_rows.append(row)
            main = site_rows[:1]              # the MNIST path's shape
            bms, by = bound(main[0]["bytes"], main[0]["flops"])
            rows.append(dict(
                name=kernel, route="cuda",
                source=f"src/repro_torch/kernels/csrc/{source}",
                replaces=replaces, launches=split_launches[f"{kernel}_f32"],
                max_abs_err=errs[kernel], ms=main[0]["ms"],
                device_ms=main[0]["device_ms"],
                cold_device_ms=main[0]["cold_device_ms"],
                plain_ms=main[0]["plain_ms"], bound_ms=bms, bound_by=by,
                library_ms=main[0]["library_ms"],
                library_device_ms=main[0]["library_device_ms"],
                empty_launch=main[0].get("empty_launch"),
                path="split path (caps_votes -> routing) and standalone "
                     "squash, MNIST width, batch 8",
                sites=site_rows))
        # K14b's cluster size at MNIST batch 8: the plan's among every
        # size, beside an empty launch of its grid.
        k14b_row = next(r for r in rows if r["name"] == "routing_cluster")
        k14b_row.update(cluster=rt_cs, ctas=b_ * rt_cs, mode=rt_mode,
                        empty_launch=empty_floor(b_, rt_cs, rt_smem))

        def k14b_plan_at(cs):
            try:
                return execplan.plan_routing_split(i_, lay.num_caps, jd,
                                                   iters=it, batch=b_,
                                                   cluster=cs)
            except execplan.PlanError:
                return None

        k14b_row["cluster_sweep"] = {"MNIST, 8": cluster_sweep(
            f"K14b MNIST batch {b_}", k14b_plan_at,
            lambda sc, cs: k14b.routing(
                u_hat, iters=it, num_classes=lay.num_caps, mode=sc.mode,
                block_i=sc.block_i, cluster=cs),
            lambda sc, cs: k14b.cluster_occupancy(
                i_, lay.num_caps, lay.caps_dim, mode=sc.mode,
                block_i=sc.block_i, cluster=cs))}
        k14b_row["planned_over_best"] = sweep_miss(
            f"K14b MNIST batch {b_}", k14b_row["cluster_sweep"]["MNIST, 8"],
            rt_cs)
        print(f"K14b MNIST batch {b_}: device {k14b_row['device_ms']} ms, "
              f"bound {k14b_row['bound_ms']:.6f} ms ({k14b_row['bound_by']})"
              f", empty launch {json.dumps(k14b_row['empty_launch'])}",
              flush=True)

        def split_path():
            return ops.routing(ops.caps_votes(u_pc, wcc, plan=perop),
                               plan=perop)

        def fused_path():
            return ops.votes_routing(u_pc, wcc, plan=perop)

        split_ms, fused_ms = time_ms(split_path), time_ms(fused_path)
        split_dev, fused_dev = device_ms(split_path), device_ms(fused_path)
        # The knobs: K14a's rows a CTA (threads and columns a thread
        # follow), K10's lanes a row and rows a CTA, forward and backward.
        sweep = {bi: dict(grid=execplan.caps_votes_grid(i_, jd, bi),
                          device_ms=device_ms(lambda bi=bi: k14a.caps_votes(
                              u_pc, wcc, block_i=bi)))
                 for bi in (1, 2, 4, 8, 16, 32)}
        rows_sweep = {}
        for label, x_, g_, knobs in (
                ("[9216, 8]", rows_pc, g_pc,
                 [(2, br) for br in (16, 32, 64, 128)]
                 + [(1, br) for br in (32, 64, 128, 256)]),
                ("[4096, 256]", x_wide, g_wide,
                 [(32, br) for br in (1, 2, 4, 8)] + [(16, 8), (8, 8)])):
            for lanes, br in knobs:
                rows_sweep[f"{label} lanes {lanes} block_rows {br}"] = dict(
                    grid=execplan.squash_grid(x_.shape[0], br, lanes),
                    fwd_device_ms=device_ms(
                        lambda x_=x_, br=br, lanes=lanes: k10.squash_rows(
                            x_, block_rows=br, lanes=lanes)),
                    bwd_device_ms=device_ms(
                        lambda x_=x_, g_=g_, br=br, lanes=lanes:
                        k10.squash_bwd(x_, g_, block_rows=br, lanes=lanes)))
        next(r for r in rows if r["name"] == "caps_votes")[
            "block_i_sweep"] = sweep
        next(r for r in rows if r["name"] == "squash")[
            "lanes_rows_sweep"] = rows_sweep
    split_bytes, uhat_bytes = execplan.split_votes_routing_global_bytes(
        b_, i_, c_, jd)
    fused_once = 4.0 * (u_pc.numel() + wcc.numel() + b_ * jd)
    print(f"caps_votes device ms by block_i: {json.dumps(sweep)}",
          flush=True)
    print(f"squash device ms by lanes and block_rows: "
          f"{json.dumps(rows_sweep)}", flush=True)
    print(f"split vs fused at batch {b_}: split (caps_votes -> routing) "
          f"{split_ms:.4f} ms (device {split_dev} ms), modeled global "
          f"bytes {split_bytes:.0f} of which u_hat {uhat_bytes:.0f} "
          f"({uhat_bytes / split_bytes:.1%}); fused ({vr.mode}, "
          f"{vr.cluster}-CTA clusters) {fused_ms:.4f} ms "
          f"(device {fused_dev} ms), each tensor once {fused_once:.0f} B, "
          f"as the plan models it (W per sample per pass, mostly from L2) "
          f"{vr.global_bytes:.0f} B", flush=True)

    # 12. Deep stacks at the full width of capsnet-svhn.
    deep_stacks(dev, rng, rows, dict(
        u=u, wcc=wcc, tu=tu, g=g, vr=vr, mst=mst, su=su,
        swcc=swcc, svr=svr, lay=lay, k3_err=errs["votes_routing_cluster"],
        k4_err=errs["votes_routing_streamed_cluster"]))
    # Phase 5b's launches after each shrink, on the rows of its kernels.
    for row in rows:
        if f"{row['name']}_f32" in ENGINE_KERNELS:
            row["degraded_serve_launches"] = {
                label: counts[f"{row['name']}_f32"]
                for label, counts in degraded.items()}
    return rows


if __name__ == "__main__":
    sys.exit(main())
