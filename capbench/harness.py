"""One run of one cell: set-up, the measured window, the result.

``run_cell`` is the whole run but the command line and the look for the
card (``run.py``): the CPU tests drive it at a configuration's smoke
sizes on the kernels' plain twins.  What a cell builds on the card,
draws from the seed and hands the program comes from its configuration's
family (``families/<family>.py``, ``spec.family_of``), so a new kind of
model is new files only.
"""

from __future__ import annotations

import gc
import sys
import time

import torch

from capbench import spec, trace

TRACE_ATTEMPTS = 3
MAX_TRACE_S = 10.0


def __getattr__(name: str):
    # ``KERNEL_LIBRARIES``, the default family's libraries, for
    # chipjobs/idle_by_span.py only: it goes once that script asks
    # ``spec.family_of(cfg)``.  Looked up here, so that importing the
    # harness loads no family.
    if name == "KERNEL_LIBRARIES":
        return spec.family(spec.DEFAULT_FAMILY).LIBRARIES
    raise AttributeError(name)


class Ctx:
    """What a traffic driver is handed: the configuration (the file's
    dict and the program's type), the cell's parameters, the device, the
    seed, and the weights and the pool made from it.  The pool's entries
    read as attributes too (``ctx.images``).  Keywords beyond these join
    the pool (``images=x, labels=y``), for the callers written before
    ``pool=`` (capbench/tests/test_capbench_traffic.py,
    chipjobs/idle_by_span.py); ``**entries`` goes once they pass
    ``pool=``."""

    def __init__(self, *, cfg: dict, pcfg, mix: dict, params: dict,
                 limits: dict, device: torch.device, seed: int,
                 weights: dict, pool: dict | None = None, **entries):
        self.cfg, self.pcfg, self.mix = cfg, pcfg, mix
        self.params, self.limits = params, limits
        self.device, self.seed, self.weights = device, seed, weights
        self.pool = {**(pool or {}), **entries}

    def __getattr__(self, name: str):
        try:
            return self.__dict__["pool"][name]
        except KeyError:
            raise AttributeError(name) from None


class GcWatch:
    """The interpreter's garbage collections while it is open: how many
    of each generation, and the longest and total pause (ms)."""

    def __init__(self):
        self.pauses = {0: [], 1: [], 2: []}
        self._t = 0.0

    def _cb(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.pauses[info["generation"]].append(time.perf_counter()
                                                   - self._t)

    def __enter__(self):
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._cb)
        return False

    def note(self) -> str:
        return ", ".join(
            f"gen{g} {len(p)} (max {1e3 * max(p, default=0):.3f} ms, total "
            f"{1e3 * sum(p):.3f} ms)" for g, p in self.pauses.items())


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace_on: bool, *,
             device: torch.device, t0: float, cfg: dict | None = None,
             control: bool = False, bench_dir=spec.HERE) -> dict:
    """Run ``cell`` once and return the result line's fields.  ``cfg``
    replaces the cell's configuration (the tests' smoke sizes);
    ``control`` also reads the control's numbers (``control_checks``),
    which the benchmark's own runs never do."""
    cfg = cfg if cfg is not None else cell.config
    family = spec.family_of(cfg)
    marks = [("start", time.perf_counter())]
    if device.type == "cuda":
        from repro_torch.kernels import build
        built = build.build(family.LIBRARIES)  # nvcc once a checkout
        marks.append((f"nvcc {len(built)}", time.perf_counter()))
    weights = family.weights(cfg, seed, device)
    pool = family.pool(cfg, cell.params, seed, device)
    sync(device)
    marks.append(("inputs", time.perf_counter()))
    ctx = Ctx(cfg=cfg, pcfg=family.program_config(cfg), mix=cell.mix,
              params=cell.params, limits=cell.limits, device=device,
              seed=seed, weights=weights, pool=pool)
    driver = spec.driver(cell.mix["driver"])(ctx)
    sync(device)
    marks.append(("program and warm-up", time.perf_counter()))
    # What is alive now (modules, weights, plans) lives as long as the
    # process, as in a server after start-up: freeze it, so that the
    # window's collections scan only what the window makes.
    gc.collect()
    gc.freeze()
    marks.append(("gc freeze", time.perf_counter()))
    setup_s = marks[-1][1] - t0
    log(f"set-up {setup_s:.3f} s: before the cell {marks[0][1] - t0:.3f}, "
        + ", ".join(f"{n} {b - a:.3f}" for (_, a), (n, b)
                    in zip(marks, marks[1:])))
    for k, v in getattr(driver, "setup_marks", {}).items():
        log(f"set-up of the program, {k}: {v:.3f} s")
    out: dict = {}
    watch = GcWatch()
    if not trace_on:
        with watch:
            rec = driver.window(seconds, trace.no_span)
        driver.drain()
        e2e = dict(driver.end_to_end(rec), setup_s=setup_s)
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    else:
        tsec = min(seconds, MAX_TRACE_S)
        for attempt in range(TRACE_ATTEMPTS):
            with watch:
                events, rec, whole, info = trace.traced(
                    lambda: driver.window(tsec, trace.span))
            driver.drain()
            if whole:
                break
            log(f"trace window {attempt + 1} lost records ({info}): "
                f"profiling a fresh window")
        else:
            raise RuntimeError(f"no whole trace in {TRACE_ATTEMPTS} "
                               f"windows; no numbers from a partial one")
        summ = trace.summary(events)
        del events
        got = dict(window=rec, trace=summ, cell=cell.params, cfg=cfg)
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(m["name"], bench_dir)(got)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out["busy_s"] = summ["busy_s"]
        out["window_s"] = summ["window_s"]
        out["breakdown"] = {"device_ops": summ["device_ops"],
                            "idle_gaps": summ["idle_gaps"]}
    for k, v in driver.notes(rec).items():
        log(f"{k}: {v}")
    log(f"python gc in the window: {watch.note()}")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    attempted, failed = driver.counts()
    gc.unfreeze()                        # the program's state can go now
    checks = driver.check()
    if control:
        out["control_checks"] = driver.check("tf32")
    del driver, weights, pool, ctx
    gc.collect()
    out.update(metrics=metrics, checks=checks, attempted=attempted,
               failed=failed, memory_peak_bytes=peak)
    out["correct"] = (failed == 0 and all(
        c["value"] <= c["limit"] for c in checks.values()))
    return out
