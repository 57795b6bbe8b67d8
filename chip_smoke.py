#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (the H100).

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``,
holds every kernel against its plain PyTorch twin on the card at the
MNIST CapsuleNet's shapes (both routing schedules), runs the full-width
forward on the pipelined and the per-op plan against the plain forward,
serves 32 seeded requests through ``CapsuleEngine``, and times each
kernel at the engine's batch.  The weights are random, made from a seed.
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

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
SLOTS = 8                       # the engine's batch: every timed shape uses it
N_REQUESTS = 32
# NVIDIA H100 SXM data sheet (dense, no sparsity), at its 700 W limit.
PEAK_FP32_FLOPS = 67e12         # fp32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12

# Tolerances of the kernel-vs-twin checks, with their reasons.
EXACT = (0.0, 0.0, "a gather copies values: bit-identical")
SHORT_SUM = (1e-5, 1e-5, "81-term fp32 dot products summed in another "
             "order (the reference's conv tolerance)")
LONG_SUM = (1e-4, 2e-5, "20,736-term fp32 dot products summed in another "
            "order: rounding grows like sqrt(K) * 2^-24 * sum|terms|")
ROUTING = (1e-4, 1e-5, "fp32 sums over up to 1152 capsules (and the "
           "20,736-term producer) in another order, through 3 routing "
           "iterations")


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


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def main() -> int:
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
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import capsnet_mnist
    from repro_torch.core import capsnet, execplan
    from repro_torch.kernels import build
    from repro_torch.kernels import conv_im2col as k12
    from repro_torch.kernels import primary_routing as k5
    from repro_torch.kernels import votes_routing as k34
    from repro_torch.kernels.ref import squash
    from repro_torch.serve.capsule import CapsRequest, CapsuleEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. The card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}", flush=True)

    # 2. Build the kernels from the checkout's sources.
    t0 = time.perf_counter()
    built = build.build()
    print(f"build: compiled {built or 'nothing (up to date)'} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

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
    def conv_inputs(cfg_, params_, images_):
        x1 = torch.relu(capsnet._conv_nhwc(images_, params_["conv1_w"],
                                           params_["conv1_b"], 1))
        pre = capsnet._conv_nhwc(x1, params_["pc_w"], params_["pc_b"],
                                 cfg_.pc_stride)
        u = squash(pre.reshape(images_.shape[0], cfg_.num_primary,
                               cfg_.primary_dim))
        return x1, u

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
    vr, pr = perop.op(execplan.FUSED_NAME), plan.op(execplan.PIPE_NAME)
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

    held("im2col_patches", "K1 im2col Conv1",
         k12.im2col_patches(images, kh=k1, kw=k1), p1, EXACT)
    held("im2col_patches", "K1 im2col PrimaryCaps",
         k12.im2col_patches(x1, kh=kp, kw=kp, stride=cfg.pc_stride), ppc,
         EXACT)
    held("matmul_bias_act", "K2 GEMM Conv1 bias+ReLU",
         k12.matmul_bias_act(p1.reshape(m1, -1), w1, params["conv1_b"],
                             block_m=c1.block_m, block_k=c1.block_k,
                             block_n=c1.block_n, epilogue="relu"),
         k12.matmul_bias_act_plain(p1.reshape(m1, -1), w1, params["conv1_b"],
                                   epilogue="relu"), SHORT_SUM)
    held("matmul_bias_act", "K2 GEMM PrimaryCaps bias+squash",
         k12.matmul_bias_act(ppc.reshape(mpc, -1), wpc, params["pc_b"],
                             block_m=pc.block_m, block_k=pc.block_k,
                             block_n=pc.block_n, epilogue="squash",
                             squash_dim=cfg.primary_dim),
         k12.matmul_bias_act_plain(ppc.reshape(mpc, -1), wpc, params["pc_b"],
                                   epilogue="squash",
                                   squash_dim=cfg.primary_dim), LONG_SUM)
    for (label, uu, ww, op) in (
            ("K4 votes_routing streamed, MNIST", u, wcc, vr),
            ("K3 votes_routing resident, smoke", su, swcc, svr)):
        held("votes_routing", label,
             k34.votes_routing(uu, ww, mode=op.mode, block_i=op.block_i),
             k34.votes_routing_plain(uu, ww, iters=3, num_classes=10,
                                     mode=op.mode, block_i=op.block_i),
             ROUTING)
    held("votes_routing", "K4 votes_routing streamed, smoke, ragged i",
         k34.votes_routing(su, swcc, mode="streamed", block_i=24),
         k34.votes_routing_plain(su, swcc, iters=3, num_classes=10,
                                 mode="streamed", block_i=24), ROUTING)
    for (label, pp, wp, bp, ww, op) in (
            ("K5 primary_routing streamed, MNIST", ppc, wpc, params["pc_b"],
             wcc, pr),
            ("K5 primary_routing resident, smoke", sppc, swpc,
             sparams["pc_b"], swcc, spr)):
        held("primary_routing", label,
             k5.primary_routing_patches(pp, wp, bp, ww, mode=op.mode,
                                        block_i=op.block_i,
                                        block_k=op.block_k),
             k5.primary_routing_patches_plain(pp, wp, bp, ww, iters=3,
                                              num_classes=10, mode=op.mode,
                                              block_i=op.block_i), ROUTING)
    assert plan.op(execplan.PIPE_NAME).mode == "streamed"
    assert perop.op(execplan.FUSED_NAME).mode == "streamed"
    assert splan.op(execplan.PIPE_NAME).mode == "resident"

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
    if launches["per-op"]["votes_routing_f32"] < 1 or \
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

    # 6. Each kernel's time at the engine's batch against its bound, after
    # the whole forward's on each plan.
    with torch.no_grad():
        fwd_ms = {label: time_ms(lambda p=p, b=b: capsnet.forward(
            params, images, cfg, backend=b, plan=p, device=dev))
            for label, p, b in (("kernels, pipelined plan", plan, "kernels"),
                                ("kernels, per-op plan", perop, "kernels"),
                                ("torch", None, "torch"))}
    print(f"forward ms at batch {SLOTS}: {json.dumps(fwd_ms)}", flush=True)
    b_ = SLOTS
    i_, jd, c_, it = lay.in_caps, lay.jd, lay.in_dim, lay.iters
    routing_flops = 2.0 * b_ * i_ * jd * (c_ + 2 * it + 1)  # votes + passes
    x_nchw, x1_nchw = images.permute(0, 3, 1, 2), x1.permute(0, 3, 1, 2)
    w1_oihw = params["conv1_w"].permute(3, 2, 0, 1)
    wpc_oihw = params["pc_w"].permute(3, 2, 0, 1)
    n1, npc = cfg.conv1_channels, cfg.pc_channels
    kk1, kkpc = p1.shape[2], ppc.shape[2]
    sites = {
        "im2col_patches": [
            ("Conv1", "main",
             lambda: k12.im2col_patches(images, kh=k1, kw=k1),
             lambda: k12.im2col_patches_plain(images, kh=k1, kw=k1), None,
             4.0 * (images.numel() + p1.numel()), 0.0),
            ("PrimaryCaps", "main",
             lambda: k12.im2col_patches(x1, kh=kp, kw=kp,
                                        stride=cfg.pc_stride),
             lambda: k12.im2col_patches_plain(x1, kh=kp, kw=kp,
                                              stride=cfg.pc_stride), None,
             4.0 * (x1.numel() + ppc.numel()), 0.0)],
        "matmul_bias_act": [
            ("Conv1", "main",
             lambda: k12.matmul_bias_act(
                 p1.reshape(m1, -1), w1, params["conv1_b"],
                 block_m=c1.block_m, block_k=c1.block_k, block_n=c1.block_n,
                 epilogue="relu"),
             lambda: k12.matmul_bias_act_plain(
                 p1.reshape(m1, -1), w1, params["conv1_b"], epilogue="relu"),
             lambda: F.conv2d(x_nchw, w1_oihw, params["conv1_b"]),
             4.0 * (m1 * kk1 + kk1 * n1 + n1 + m1 * n1),
             2.0 * m1 * kk1 * n1),
            ("PrimaryCaps", "per-op",
             lambda: k12.matmul_bias_act(
                 ppc.reshape(mpc, -1), wpc, params["pc_b"],
                 block_m=pc.block_m, block_k=pc.block_k, block_n=pc.block_n,
                 epilogue="squash", squash_dim=cfg.primary_dim),
             lambda: k12.matmul_bias_act_plain(
                 ppc.reshape(mpc, -1), wpc, params["pc_b"],
                 epilogue="squash", squash_dim=cfg.primary_dim),
             lambda: F.conv2d(x1_nchw, wpc_oihw, params["pc_b"],
                              stride=cfg.pc_stride),
             4.0 * (mpc * kkpc + kkpc * npc + npc + mpc * npc),
             2.0 * mpc * kkpc * npc)],
        "votes_routing": [
            (execplan.FUSED_NAME, "per-op",
             lambda: k34.votes_routing(u, wcc, mode=vr.mode,
                                       block_i=vr.block_i),
             lambda: k34.votes_routing_plain(u, wcc, iters=it,
                                             num_classes=lay.num_caps,
                                             mode=vr.mode,
                                             block_i=vr.block_i), None,
             4.0 * (u.numel() + wcc.numel() + b_ * jd), routing_flops)],
        "primary_routing": [
            (execplan.PIPE_NAME, "main",
             lambda: k5.primary_routing_patches(
                 ppc, wpc, params["pc_b"], wcc, mode=pr.mode,
                 block_i=pr.block_i, block_k=pr.block_k),
             lambda: k5.primary_routing_patches_plain(
                 ppc, wpc, params["pc_b"], wcc, iters=it,
                 num_classes=lay.num_caps, mode=pr.mode, block_i=pr.block_i),
             None,
             4.0 * (ppc.numel() + wpc.numel() + npc + wcc.numel() + b_ * jd),
             2.0 * mpc * kkpc * npc + routing_flops)],
    }
    meta = {
        "im2col_patches": ("conv_im2col.cu",
                           "src/repro/kernels/conv_im2col.py:54", "main"),
        "matmul_bias_act": ("conv_im2col.cu",
                            "src/repro/kernels/conv_im2col.py:150", "main"),
        "votes_routing": ("votes_routing.cu",
                          "src/repro/kernels/votes_routing.py:139",
                          "per-op"),
        "primary_routing": ("primary_routing.cu",
                            "src/repro/kernels/primary_routing.py:132",
                            "main"),
    }
    rows = []
    for kernel, kernel_sites in sites.items():
        source, replaces, path = meta[kernel]
        site_rows = []
        for (op, on, fn, plain, lib, nbytes, flops) in kernel_sites:
            bms, by = bound(nbytes, flops)
            site_rows.append(dict(
                op=op, path=on, ms=time_ms(fn), plain_ms=time_ms(plain),
                library_ms=time_ms(lib) if lib is not None else None,
                bound_ms=bms, bound_by=by, bytes=nbytes, flops=flops))
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
            plain_ms=sum(s["plain_ms"] for s in main),
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            library_ms=(sum(libs) if all(x is not None for x in libs)
                        else None),
            path=("serve, pipelined plan" if path == "main"
                  else "forward, per-op plan"),
            sites=site_rows))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
