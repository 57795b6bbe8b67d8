"""A profiled window and what the benchmark reads from it.

``traced(fn)`` runs ``fn`` once under ``torch.profiler`` (CPU and CUDA
activity), between marker kernels: LEAD ``frac_`` launches and a device
spin take the records a profiling session loses at its start, then
GUARD ``trunc_`` launches, ``fn``, GUARD ``floor_`` launches.  The trace
is whole when it holds every guard on both sides, and when, from the
first guard on, every kernel launch has its device record and every
device record its launch, matched by correlation id
(``launch_check``).  ``torch.profiler`` does lose records now and then,
so a caller profiles a fresh window when one is not whole, and reports
nothing from a partial trace.

From a whole trace: the seconds in which anything ran on the device
(the union of device records inside the window's host span), the
window's length, the device operations that took most time, and the
idle gaps labelled by the benchmark's own host span that covers them.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

import torch

LEAD = 64                  # frac_ kernels that open a session
SPIN_CYCLES = 10_000_000   # then ~5 ms of device spin
GUARD = 8                  # trunc_ kernels before the window, floor_ after
WINDOW = "capbench.window"
HOST_SPANS = ("capbench.submit", "capbench.step", "capbench.wait",
              "capbench.train_step", "capbench.drain")
TOP = 10


def span(name: str):
    """A host span the trace records (``record_function``)."""
    return torch.profiler.record_function(name)


def no_span(name: str):
    return contextlib.nullcontext()


def on_device(e) -> bool:
    """A record of work on the device: not a host span's copy on the
    device timeline (``record_function`` puts one there)."""
    return (e.device_type() == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation())


def launch_check(events) -> tuple[int, int]:
    """The kernel launches whose device record the trace lacks, and the
    kernel records whose launch it lacks, from the first ``trunc_`` guard
    on (a copy or a fill has no kernel launch)."""
    kernels, device = set(), defaultdict(list)
    for e in events:
        name, corr = e.name(), e.correlation_id()
        if e.is_user_annotation():
            continue
        if on_device(e):
            device[corr].append(name)
        elif "LaunchKernel" in name or "LaunchCooperativeKernel" in name:
            kernels.add(corr)
    first = min((corr for corr, names in device.items()
                 if any("trunc_kernel" in n for n in names)), default=None)
    if first is None:
        return len(kernels), 0
    missing = sum(corr >= first and corr not in device for corr in kernels)
    orphans = sum(corr >= first and corr not in kernels
                  and not all(n.startswith(("Memcpy", "Memset"))
                              for n in names)
                  for corr, names in device.items())
    return missing, orphans


def traced(fn):
    """``fn()`` under the profiler between the markers; returns the
    trace's events, ``fn``'s result, whether the trace is whole, and what
    the check counted."""
    from torch.profiler import ProfilerActivity, profile
    mark = torch.ones(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD):
            mark.frac_()
        torch.cuda._sleep(SPIN_CYCLES)
        for _ in range(GUARD):
            mark.trunc_()
        torch.cuda.synchronize()
        with span(WINDOW):
            out = fn()
            torch.cuda.synchronize()
        for _ in range(GUARD):
            mark.floor_()
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    guards = defaultdict(int)
    for e in events:
        if on_device(e):
            for g in ("trunc_kernel", "floor_kernel"):
                if g in e.name():
                    guards[g] += 1
    missing, orphans = launch_check(events)
    whole = (guards["trunc_kernel"] == guards["floor_kernel"] == GUARD
             and missing == orphans == 0)
    return events, out, whole, dict(missing=missing, orphans=orphans,
                                    guards=dict(guards))


def _union(intervals) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def summary(events) -> dict:
    """What the benchmark reads from a whole trace (seconds throughout):
    ``busy_s`` (device records' union inside the window span),
    ``window_s``, ``device_ops`` (the TOP operations by device time,
    ``[name, seconds]``) and ``idle_gaps`` (idle seconds summed by the
    host span that covers each gap's middle, the TOP largest)."""
    cuda = torch.autograd.DeviceType.CUDA
    win = [e for e in events if e.name() == WINDOW
           and e.device_type() != cuda]
    if len(win) != 1:
        raise RuntimeError(f"the trace holds {len(win)} window spans")
    w0, w1 = win[0].start_ns(), win[0].end_ns()
    dev, by_name, hosts = [], defaultdict(int), []
    for e in events:
        if on_device(e):
            a, b = max(e.start_ns(), w0), min(e.end_ns(), w1)
            if b > a:
                dev.append((a, b))
                by_name[e.name()] += b - a
        elif e.name() in HOST_SPANS and e.device_type() != cuda:
            hosts.append((e.start_ns(), e.end_ns(), e.name()))
    busy = _union(dev)
    gaps = []
    at = w0
    for a, b in busy + [(w1, w1)]:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    hosts.sort()
    starts = [h[0] for h in hosts]
    idle = defaultdict(int)
    for a, b in gaps:
        mid = (a + b) // 2
        k = bisect.bisect_right(starts, mid) - 1
        # The innermost span that covers the middle: spans nest at most
        # two deep, so it is among the few latest to start before it.
        label = next((hosts[j][2] for j in range(k, max(k - 4, -1), -1)
                      if hosts[j][1] >= mid), "none")
        idle[label] += b - a
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gap_list = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(
        busy_s=sum(b - a for a, b in busy) / 1e9,
        window_s=(w1 - w0) / 1e9,
        device_ops=[[n[:120], t / 1e9] for n, t in ops],
        idle_gaps=[[n, t / 1e9] for n, t in gap_list])
