"""Serving traffic: requests through ``repro_torch``'s ``CapsuleEngine``.

The mix file (``mixes/<mix>.json``) says how requests arrive:

- ``"arrivals": "backlog"``: offline.  Before every ``step()`` the queue
  is topped up to ``backlog_per_slot`` x slots, so every tick runs full.
  The end-to-end number is the images classified ``ok`` in the window
  over the window's seconds.
- ``"arrivals": "poisson"``: an open loop at the cell's ``rate_per_s``.
  The window holds ``round(rate x seconds)`` arrivals whose gaps are the
  same set for every seed (drawn once from ``GAPS_SEED``, scaled to fill
  the window), put in an order drawn from the seed: every seed offers
  the same work, in another order.  Each request is timed from its due
  time to its result on the host, and the requests due in the window
  are all waited for.  The end-to-end number is the 95th percentile of
  those latencies; the 99th is read beside it.  An optional ``"burst"``
  (``{"period_ms", "on_ms", "on_factor"}``) makes the rate ``on_factor``
  x the mean for ``on_ms`` of every ``period_ms`` and lower in between,
  the mean kept: the same arrivals, moved in time.
- ``"arrivals": "closed"``: MLPerf Inference's MultiStream.  A query of
  ``samples_per_query`` requests is submitted at once, and the next as
  soon as the last request of the one before has its result; the window
  closes with the first query to end after ``seconds``.  Each query is
  timed from its submission to its last result on the host.  The
  end-to-end number is the 99th percentile of those latencies
  (``query_p99_ms``); the median is read beside it.  Every seed offers
  the same work: one query at a time, the images in another order.

The engine serves the kernels backend.  The cell file's ``params``:
``slots`` and the image ``pool`` size (``rate_per_s`` for an open loop),
and optionally ``plan``: ``"engine"`` (the default: the plan the engine
compiles itself, pipelined at the slot batch), ``"per_op"`` (the
per-operation plan, nothing pipelined) or ``"degraded"`` (the plan of
``execplan.degrade_plan`` under ``smem_fraction`` of a CTA's shared
memory).  Images come from the seeded pool in an order drawn from the
seed.

Correctness: a sample of the window's finished requests, drawn from the
seed, against the plain reference's lengths on the same images and
weights (``lengths_gap``: the widest gap over a request's classes, over
the reference's largest length of that request; the worst request).
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from capbench import inputs, work
from capbench.reference import capsnet_ref

GAPS_SEED = 20_191_212
SAMPLE = 512
REF_BLOCK = 64
WARM_TICKS = 4


def arrival_gaps(rate: float, seconds: float) -> np.ndarray:
    """The window's gaps between arrivals, the same for every seed:
    ``round(rate x seconds) + 1`` exponential gaps that sum to
    ``seconds`` (the last one after the window's last arrival)."""
    n = max(1, round(rate * seconds))
    gaps = np.random.default_rng(GAPS_SEED).exponential(1.0, n + 1)
    return gaps * (seconds / gaps.sum())


def arrival_offsets(rate: float, seconds: float, seed: int,
                    burst: dict | None = None) -> np.ndarray:
    """Seconds from the window's start at which each request is due: the
    gaps in an order drawn from the seed, and under ``burst`` moved in
    time so that the rate follows its on/off profile."""
    gaps = arrival_gaps(rate, seconds)
    out = np.cumsum(gaps[inputs.np_rng(seed, 1).permutation(len(gaps))])[:-1]
    return out if burst is None else burst_time(out, seconds, burst)


def burst_time(offsets: np.ndarray, seconds: float, burst: dict
               ) -> np.ndarray:
    """Map arrivals of a steady process onto an on/off one: the rate is
    ``on_factor`` x the mean for ``on_ms`` of each ``period_ms``, and as
    much lower in between that the mean is kept.  The map is the inverse
    of the profile's integral, so the count and order of arrivals stay."""
    period, on = burst["period_ms"] / 1e3, burst["on_ms"] / 1e3
    hi = burst["on_factor"]
    lo = (1.0 - hi * on / period) / (1.0 - on / period)
    if not (0 < on < period and hi > 1 and lo >= 0):
        raise ValueError(f"burst {burst}: the on share x on_factor must "
                         f"stay at or under 1")
    edges = np.unique(np.concatenate([
        np.arange(0.0, seconds, period),
        np.arange(on, seconds, period), [seconds]]))
    rates = np.where(np.mod(edges[:-1] + 1e-12, period) < on, hi, lo)
    work = np.concatenate([[0.0], np.cumsum(rates * np.diff(edges))])
    return np.interp(offsets * work[-1] / seconds, work, edges)


def serving_plan(pcfg, params: dict):
    """The plan the cell's ``params`` ask for; None leaves it to the
    engine."""
    kind = params.get("plan", "engine")
    if kind == "engine":
        return None
    from repro_torch.core import execplan, planner
    if kind == "per_op":
        return execplan.compile_plan(pcfg, batch=params["slots"],
                                     pipeline=False)
    if kind == "degraded":
        budget = int(planner.SMEM_BYTES * params["smem_fraction"])
        return execplan.degrade_plan(pcfg, budget, batch=params["slots"],
                                     pipeline=True)[0]
    raise ValueError(f"unknown plan {kind!r} (engine, per_op, degraded)")


class Driver:
    def __init__(self, ctx):
        t = time.perf_counter()
        from repro_torch.serve.capsule import CapsRequest, CapsuleEngine

        self.ctx = ctx
        self.mix = ctx.mix
        p = ctx.params
        self.slots = p["slots"]
        self._req = CapsRequest
        self.engine = CapsuleEngine(ctx.weights, ctx.pcfg, slots=self.slots,
                                    backend="kernels", device=ctx.device,
                                    plan=serving_plan(ctx.pcfg, p))
        self.pool = ctx.images.cpu().numpy()
        self.order = inputs.np_rng(ctx.seed, 2).permutation(len(self.pool))
        self.next_rid = 0
        self.window_reqs: list = []
        marks = [time.perf_counter()]
        # Warm-up: full ticks, then a part-filled one (every tick runs
        # the full slot batch; only the read-back's row count varies).
        for _ in range(WARM_TICKS):
            self._fill(self.slots)
            self.engine.step()
            marks.append(time.perf_counter())
        self._fill(max(1, self.slots // 2))
        self.engine.run()
        marks.append(time.perf_counter())
        self.base = self._counters()
        self.setup_marks = {"import, plan and engine": marks[0] - t,
                            "first tick": marks[1] - marks[0],
                            "later warm ticks": marks[-1] - marks[1]}

    def _counters(self) -> dict:
        st = self.engine.stats()
        return dict(submitted=st["submitted"], ok=st["ok"])

    def _new(self, due: float | None = None):
        rid = self.next_rid
        self.next_rid += 1
        req = self._req(rid=rid, image=self.pool[self.row(rid)])
        req.due_s = due
        self.engine.submit(req)
        return req

    def row(self, rid: int) -> int:
        """The pool row of request ``rid``."""
        return int(self.order[rid % len(self.order)])

    def _fill(self, n: int) -> None:
        for _ in range(n):
            self._new()

    # -- the window ------------------------------------------------------
    def window(self, seconds: float, span) -> dict:
        eng = self.engine
        before = eng.stats()
        first = len(eng.finished)
        if self.mix["arrivals"] == "backlog":
            rec = self._backlog(seconds, span)
        elif self.mix["arrivals"] == "poisson":
            rec = self._open_loop(seconds, span)
        elif self.mix["arrivals"] == "closed":
            rec = self._closed_loop(seconds, span)
        else:
            raise ValueError(f"unknown arrivals {self.mix['arrivals']!r}")
        after = eng.stats()
        rids = rec.pop("rids", None)
        self.window_reqs = [r for r in eng.finished[first:]
                            if r.status == "ok"
                            and (rids is None or r.rid in rids)]
        ticks = after["ticks"] - before["ticks"]
        filled = (after["occupancy"] * after["ticks"]
                  - before["occupancy"] * before["ticks"]) * self.slots
        per_image = work.serve_flops(self.ctx.cfg)
        tick_bound, _ = work.bound_s(per_image * self.slots,
                                     work.serve_bytes(self.ctx.cfg,
                                                      self.slots))
        rec.update(ticks=ticks,
                   occupancy=filled / (ticks * self.slots) if ticks else None,
                   images=len(self.window_reqs),
                   flops=per_image * len(self.window_reqs),
                   bound_s=tick_bound * ticks)
        return rec

    def _backlog(self, seconds: float, span) -> dict:
        eng = self.engine
        target = self.mix["backlog_per_slot"] * self.slots
        t0 = time.perf_counter()
        end = t0 + seconds
        ticks = []
        while True:
            with span("capbench.submit"):
                self._fill(target - len(eng.queue))
            t = time.perf_counter()
            with span("capbench.step"):
                eng.step()
            ticks.append(time.perf_counter() - t)
            if time.perf_counter() >= end:
                break
        return dict(wall_s=time.perf_counter() - t0, tick_s=ticks)

    def _open_loop(self, seconds: float, span) -> dict:
        eng = self.engine
        offsets = arrival_offsets(self.ctx.params["rate_per_s"], seconds,
                                  self.ctx.seed, self.mix.get("burst"))
        t0 = time.perf_counter()
        due = t0 + offsets
        reqs, late, ticks = [], np.empty(len(due)), []
        i, n = 0, len(due)
        while True:
            now = time.perf_counter()
            if i < n and due[i] <= now:
                with span("capbench.submit"):
                    while i < n and due[i] <= now:
                        reqs.append(self._new(float(due[i])))
                        late[i] = now - due[i]
                        i += 1
            if eng.queue or any(a is not None for a in eng.active):
                t = time.perf_counter()
                with span("capbench.step"):
                    eng.step()
                ticks.append(time.perf_counter() - t)
            elif i < n:
                with span("capbench.wait"):
                    while time.perf_counter() < due[i]:
                        pass
            else:
                break
        wall = time.perf_counter() - t0
        lat = np.array([r.finished_s - r.due_s for r in reqs
                        if r.status == "ok"])
        return dict(
            wall_s=wall, tick_s=ticks, rids={r.rid for r in reqs}, offered=n,
            latency_p50_ms=1e3 * float(np.percentile(lat, 50)),
            latency_p95_ms=1e3 * float(np.percentile(lat, 95)),
            latency_p99_ms=1e3 * float(np.percentile(lat, 99)),
            late_p99_ms=1e3 * float(np.percentile(late, 99)),
            late_max_ms=1e3 * float(late.max()))

    def _closed_loop(self, seconds: float, span) -> dict:
        eng = self.engine
        n = self.mix["samples_per_query"]
        t0 = time.perf_counter()
        end = t0 + seconds
        lat, ticks, rids = [], [], set()
        while True:
            issued = time.perf_counter()
            with span("capbench.submit"):
                query = [self._new(issued) for _ in range(n)]
            while eng.queue or any(a is not None for a in eng.active):
                t = time.perf_counter()
                with span("capbench.step"):
                    eng.step()
                ticks.append(time.perf_counter() - t)
            lat.append(max(r.finished_s for r in query) - issued)
            rids.update(r.rid for r in query)
            if time.perf_counter() >= end:
                break
        lat = 1e3 * np.array(lat)
        return dict(wall_s=time.perf_counter() - t0, tick_s=ticks,
                    rids=rids, queries=len(lat),
                    query_p50_ms=float(np.percentile(lat, 50)),
                    query_p99_ms=float(np.percentile(lat, 99)),
                    query_max_ms=float(lat.max()))

    def drain(self) -> None:
        self.engine.run()

    def counts(self) -> tuple[int, int]:
        now = self._counters()
        attempted = now["submitted"] - self.base["submitted"]
        return attempted, attempted - (now["ok"] - self.base["ok"])

    def end_to_end(self, rec: dict) -> dict:
        out = {"images_per_s": rec["images"] / rec["wall_s"]}
        for name in ("latency_p95_ms", "query_p99_ms"):
            if name in rec:
                out[name] = rec[name]
        return out

    def notes(self, rec: dict) -> dict:
        t = 1e3 * np.array(rec["tick_s"])
        out = {"window": f"{rec['wall_s']:.4f} s, {rec['ticks']} ticks, "
                         f"{rec['images']} images ok",
               "step() ms": f"p50 {np.median(t):.4f}, p99 "
                            f"{np.percentile(t, 99):.4f}, max {t.max():.4f}"}
        if "late_p99_ms" in rec:
            out["latency ms"] = (f"p50 {rec['latency_p50_ms']:.4f}, p95 "
                                 f"{rec['latency_p95_ms']:.4f}, p99 "
                                 f"{rec['latency_p99_ms']:.4f}")
            out["generator lateness"] = (
                f"p99 {rec['late_p99_ms']:.4f} ms, max "
                f"{rec['late_max_ms']:.4f} ms over {rec['offered']} "
                f"arrivals")
        if "query_p99_ms" in rec:
            out["query latency ms"] = (
                f"p50 {rec['query_p50_ms']:.4f}, p99 "
                f"{rec['query_p99_ms']:.4f}, max {rec['query_max_ms']:.4f} "
                f"over {rec['queries']} queries")
        return out

    # -- correctness -------------------------------------------------------
    def check(self, precision: str = "fp32") -> dict:
        """The served lengths of a seeded sample of the window's requests
        against the reference's.  ``precision="tf32"`` reads the control:
        the reference in TF32 in the program's place.  The first call
        frees the program's state before the reference runs."""
        if self.engine is not None:
            reqs = self.window_reqs
            pick = inputs.np_rng(self.ctx.seed, 3).choice(
                len(reqs), size=min(SAMPLE, len(reqs)), replace=False)
            self.rows = torch.tensor([self.row(reqs[k].rid) for k in pick])
            self.got = np.stack([reqs[k].lengths for k in pick])
            self.engine = self.window_reqs = None
            gc.collect()
            if self.ctx.device.type == "cuda":
                torch.cuda.empty_cache()
            self.ref = reference_lengths(self.ctx, self.rows, "fp32")
        got = (self.got if precision == "fp32"
               else reference_lengths(self.ctx, self.rows, precision))
        gap = float(np.max(np.abs(got - self.ref).max(axis=1)
                           / np.abs(self.ref).max(axis=1)))
        return {"lengths_gap": {"value": gap,
                                "limit": self.ctx.limits["lengths_gap"]}}


def reference_lengths(ctx, rows: torch.Tensor, precision: str) -> np.ndarray:
    """The reference's lengths of the pool rows ``rows``, in blocks."""
    p = capsnet_ref.Precision(precision)
    out = []
    with torch.no_grad(), p.context():
        for k in range(0, len(rows), REF_BLOCK):
            x = ctx.images[rows[k:k + REF_BLOCK].to(ctx.device)]
            out.append(capsnet_ref.lengths(ctx.weights, x, ctx.cfg, p).cpu())
    return torch.cat(out).numpy()
