"""Label a traced serving window's idle gaps by the program's spans.

    python3 chipjobs/idle_by_span.py --workload mnist-offline --seed <n> \\
        --seconds 10 [--out idle.json]

Runs the cell's set-up as ``capbench/run.py`` does, then one window under
``capbench.trace.traced`` (the benchmark's own markers and wholeness
check).  Each idle gap of the device inside the window gets the
innermost span (benchmark or program) over its middle; device time gets
the innermost span over its kernel's launch.  Reports the benchmark's
own ``capbench.step`` idle beside the same gaps summed by their
innermost ``engine.*`` span, the program's spans against the profiler's
records of them (the clock), and the serving metrics read from
``repro_torch.obs``.  A one-off analysis, not part of the benchmark.
"""

import argparse
import json
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import torch  # noqa: E402

from capbench import harness, inputs, spec, trace  # noqa: E402

PREFIXES = ("capbench.", "engine.", "plan.", "model.", "train.")


def innermost(spans, points):
    """For each point (sorted), the innermost of the nested ``spans``
    ``(start, end, name)`` over it, or None."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, k = [], [], 0
    for p in points:
        while k < len(spans) and spans[k][0] <= p:
            while stack and stack[-1][1] < spans[k][0]:
                stack.pop()
            stack.append(spans[k])
            k += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def flatten(spans):
    """The nested ``spans`` as consecutive pieces ``(start, end, innermost,
    benchmark)``: each moment under its innermost span and the
    benchmark span (``capbench.*`` but the window) around it."""
    bounds = []
    for a, b, n in spans:
        bounds += [(a, 1, -b, n), (b, 0, 0, n)]
    bounds.sort()
    out, stack, prev = [], [], None
    for t, start, _, n in bounds:
        if stack and t > prev:
            bench = next((m for m in stack if m.startswith("capbench.")
                          and m != trace.WINDOW), "none")
            out.append((prev, t, stack[-1], bench))
        if start:
            stack.append(n)
        else:
            stack.pop()
        prev = t
    return out


def split(gaps, pieces) -> dict:
    """Idle ns of ``gaps`` by the (benchmark, innermost) span over each
    part of them; parts under no span count as ("none", "none")."""
    out, k = defaultdict(int), 0
    for a, b in gaps:
        at = a
        while k < len(pieces) and pieces[k][1] <= a:
            k += 1
        j = k
        while j < len(pieces) and pieces[j][0] < b:
            p0, p1, inner, bench = pieces[j]
            lo, hi = max(p0, a), min(p1, b)
            if lo > at:
                out[("none", "none")] += lo - at
            if hi > lo:
                out[(bench, inner)] += hi - lo
                at = hi
            j += 1
        if b > at:
            out[("none", "none")] += b - at
    return out


def analyse(events, snap) -> dict:
    cuda = torch.autograd.DeviceType.CUDA
    win = [e for e in events if e.name() == trace.WINDOW
           and e.device_type() != cuda][0]
    w0, w1 = win.start_ns(), win.end_ns()
    dev, hosts, launches = [], [], {}
    for e in events:
        if trace.on_device(e):
            a, b = max(e.start_ns(), w0), min(e.end_ns(), w1)
            if b > a:
                dev.append((a, b, e.correlation_id()))
        elif e.device_type() != cuda and e.name().startswith(PREFIXES):
            hosts.append((e.start_ns(), e.end_ns(), e.name()))
        elif e.device_type() != cuda and "Launch" in e.name():
            launches[e.correlation_id()] = e.start_ns()
        elif e.device_type() != cuda and "Memcpy" in e.name():
            launches[e.correlation_id()] = e.start_ns()
    busy = trace._union([(a, b) for a, b, _ in dev])
    gaps, at = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    # Each gap: the innermost span and the benchmark span over its middle.
    mids = [(a + b) // 2 for a, b in gaps]
    inner = innermost(hosts, mids)
    bench = innermost([h for h in hosts if h[2].startswith("capbench.")
                       and h[2] != trace.WINDOW], mids)
    by_inner, by_pair = defaultdict(int), defaultdict(int)
    for (a, b), i, o in zip(gaps, inner, bench):
        iname = i[2] if i else "none"
        oname = o[2] if o else "none"
        by_inner[iname] += b - a
        by_pair[f"{oname} > {iname}"] += b - a
    under_step = {k.split(" > ")[1]: v for k, v in by_pair.items()
                  if k.startswith("capbench.step > ")}
    # Each gap split exactly over the spans under its parts.
    parts = split(gaps, flatten(hosts))
    split_step = {i: v for (o, i), v in parts.items()
                  if o == "capbench.step"}
    summ = trace.summary(events)
    bench_step = dict(summ["idle_gaps"]).get("capbench.step", 0.0)
    # Device time by the innermost span over each kernel's launch.
    dev_by = defaultdict(int)
    pts = sorted((launches.get(c, a), b - a) for a, b, c in dev)
    for (p, d), s in zip(pts, innermost(hosts, [p for p, _ in pts])):
        dev_by[s[2] if s else "none"] += d
    # The clock: the program's engine.step against the profiler's.
    prof_steps = sorted((h for h in hosts if h[2] == "engine.step"))
    mine = sorted((s.start_ns, s.end_ns) for s in snap.spans
                  if s.name == "engine.step")
    lead = [m[0] - p[0] for p, m in zip(prof_steps, mine)]
    tail = [p[1] - m[1] for p, m in zip(prof_steps, mine)]
    durs = defaultdict(list)
    for s in snap.spans:
        durs[s.name].append((s.end_ns - s.start_ns) / 1e6)
    ms = {k: dict(n=len(v), median=statistics.median(v),
                  mean=statistics.fmean(v)) for k, v in sorted(durs.items())}
    return dict(
        window_s=(w1 - w0) / 1e9, busy_s=summ["busy_s"],
        idle_s=sum(b - a for a, b in gaps) / 1e9,
        bench_step_idle_s=bench_step,
        under_step_idle_s={k: v / 1e9 for k, v in sorted(
            under_step.items(), key=lambda kv: -kv[1])},
        under_step_sum_s=sum(under_step.values()) / 1e9,
        split_under_step_s={k: v / 1e9 for k, v in sorted(
            split_step.items(), key=lambda kv: -kv[1])},
        split_sum_s=sum(parts.values()) / 1e9,
        idle_by_innermost_s={k: v / 1e9 for k, v in sorted(
            by_inner.items(), key=lambda kv: -kv[1])},
        device_by_span_s={k: v / 1e9 for k, v in sorted(
            dev_by.items(), key=lambda kv: -kv[1])},
        clock=dict(steps=[len(prof_steps), len(mine)],
                   lead_us=[min(lead) / 1e3, statistics.median(lead) / 1e3,
                            max(lead) / 1e3] if lead else None,
                   tail_us=[min(tail) / 1e3, statistics.median(tail) / 1e3,
                            max(tail) / 1e3] if tail else None),
        span_ms=ms,
        samples={k: dict(n=len(v), p50_ms=1e3 * statistics.median(v),
                         max_ms=1e3 * max(v))
                 for k, v in snap.samples.items()})


def cell_driver(workload: str, seed: int):
    """The cell and its traffic driver after set-up, as ``run.py`` has
    them before its window."""
    from repro_torch.kernels import build
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.build(harness.KERNEL_LIBRARIES)
    cell = spec.cell(workload)
    cfg = cell.config
    x, y = inputs.images(cfg, cell.params["pool"], seed, dev)
    ctx = harness.Ctx(cfg=cfg, pcfg=inputs.program_config(cfg), mix=cell.mix,
                      params=cell.params, limits=cell.limits, device=dev,
                      seed=seed, weights=inputs.weights(cfg, seed, dev),
                      images=x, labels=y)
    return cell, spec.driver(cell.mix["driver"])(ctx)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    from repro_torch import obs
    cell, driver = cell_driver(args.workload, args.seed)
    cfg = cell.config
    import gc
    gc.collect()
    gc.freeze()
    for attempt in range(3):
        obs.reset()
        t = time.perf_counter()
        events, rec, whole, info = trace.traced(
            lambda: driver.window(args.seconds, trace.span))
        wall = time.perf_counter() - t
        driver.drain()
        if whole:
            break
        print(f"attempt {attempt}: not whole {info}", file=sys.stderr)
    else:
        return 1
    snap = obs.snapshot()
    out = analyse(events, snap)
    got = dict(window=rec, trace={}, cell=cell.params, cfg=cfg)
    out["metrics"] = {
        m: spec.reader(m)(got) for m in
        ("tick_host_ms.offline", "dispatch_ms.offline",
         "queue_wait_p95_ms.server")}
    out.update(workload=args.workload, seed=args.seed, traced_wall_s=wall,
               ticks=rec.get("ticks"), whole=whole,
               card=torch.cuda.get_device_name(0))
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
