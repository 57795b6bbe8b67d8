"""Slot-based batched CapsuleNet inference engine: ``repro/serve/capsule.py``'s
hardened ``CapsuleEngine`` and its ``AsyncCapsuleServer`` in PyTorch.

A fixed number of batch slots share one plan-driven forward.  Each tick
fills free slots from the queue and runs the whole slot batch through
the forward once, so the ExecutionPlan is compiled once (``pipeline=True``
on the kernels backend) and amortized across the request stream.
Inactive slots hold zero images; the capsule head is per-sample, so they
never perturb active requests.  A caller-supplied ``plan`` must be
compiled for ``batch >= slots``: every tick runs all slot rows, so a
smaller plan batch is refused up front with a ``PlanError`` naming both
numbers.

The slot batch lives on the device, and only the slots dirtied since the
last tick (admissions, retries, and freed slots returning to zeros) are
uploaded.

**Graceful degradation.**  The engine is hardened against every fault
``core/faults.py`` injects at its two sites (``engine.tick`` after
admission and before dispatch: ``vmem_shrink``, ``slot_corrupt``,
``stall``; ``engine.forward``: ``plan_error`` before the forward,
``nan_output`` / ``inf_output`` after it).  With injection off none of
these paths changes a result:

* Every request ends in exactly one terminal ``status``: ``ok``;
  ``timeout`` when its ``deadline_s`` expires in the queue, in a slot or
  in retry backoff; ``error`` when its lengths stay non-finite past
  ``max_retries`` (or its slot reaches ``quarantine_after``); ``shed``
  when the bounded queue (``max_queue``) is full -- ``admission="reject"``
  sheds the newcomer, ``"shed-oldest"`` the head of the queue -- or when
  every slot is quarantined and the backlog cannot be served.
* **Retries.**  A non-finite row is retried after a backoff of
  ``retry_backoff_ticks`` times its retry count, with the clean host
  image uploaded again (which heals a corrupted device row).
* **Quarantine.**  ``quarantine_after`` consecutive poisoned results
  through one slot quarantine it; ``probation_ticks`` consecutive clean
  ticks, a plan swap or a breaker trip lift it.
* **The breaker.**  ``breaker_after`` consecutive ``PlanError``s from
  the forward (an injected ``plan_error``) switch the engine to the
  plain ``backend="torch"`` forward on the same device, with
  ``degraded=True``.  Any other exception from the forward propagates
  out of ``step``: a kernel that fails to build or launch stops the
  engine and is never hidden behind the plain path.
* **The replan.**  A ``vmem_shrink(factor)`` scales the original
  shared-memory budget; at that tick boundary the engine calls
  ``execplan.degrade_plan`` for the slot batch and swaps in the reduced
  plan, keeping the device slot batch.  The replan is idempotent across
  the fault window; a budget with no plan trips the breaker.
* ``run`` raises ``EngineStalled`` after ``stall_ticks`` ticks without a
  terminal event while work is pending, or when ``max_ticks`` runs out.

``_forward_builds`` stands in for the reference's count of jit traces:
it is 1 after the first dispatch and goes up by one at the first
dispatch after each plan swap or breaker trip.

Designed differences from the reference: the forward is eager PyTorch,
so nothing is traced or jitted, and the active rows are gathered on
the device by their slot list; the engine serves on one device (no
``n_shards``: ``stats()`` reports one shard of every slot); the breaker
takes only ``PlanError`` (the reference's takes every exception, since
its fallback runs on the same TPU, where here it would hide a broken
CUDA kernel); its fallback is the plain ``torch`` backend, the port's
reference path.
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core import capsnet, execplan, faults
from repro_torch.core.capsnet import CapsNetConfig
from repro_torch.core.execplan import ExecutionPlan, PlanError, compile_plan
from repro_torch.core.planner import SMEM_BYTES
from repro_torch.device import resolve_device

TERMINAL_STATUSES = ("ok", "timeout", "error", "shed")
ADMISSIONS = ("reject", "shed-oldest")


class EngineStalled(RuntimeError):
    """``CapsuleEngine.run`` saw no progress (or ran out of ``max_ticks``)
    with work still pending."""


@dataclasses.dataclass
class CapsRequest:
    rid: int
    image: np.ndarray                  # [H, W, C] float in [0, 1]
    deadline_s: float | None = None    # submit-relative expiry (None: never)
    submitted_s: float | None = None
    finished_s: float | None = None
    queue_ticks: int = 0               # ticks spent waiting for a slot
    retries: int = 0                   # non-finite-output retries consumed
    status: str = "pending"            # -> ok | timeout | error | shed
    lengths: np.ndarray | None = None  # [num_classes] capsule lengths
    pred: int | None = None

    @property
    def latency_s(self) -> float | None:
        if self.submitted_s is None or self.finished_s is None:
            return None
        return self.finished_s - self.submitted_s


class CapsuleEngine:
    """Continuous-batching CapsNet classifier over a request queue."""

    def __init__(self, params, cfg: CapsNetConfig = CapsNetConfig(), *,
                 slots: int = 8, backend: str = "kernels",
                 device: str | torch.device = "cuda",
                 plan: ExecutionPlan | None = None,
                 max_queue: int | None = None, admission: str = "reject",
                 max_retries: int = 2, retry_backoff_ticks: int = 1,
                 quarantine_after: int = 3, breaker_after: int = 3,
                 probation_ticks: int | None = 8, stall_ticks: int = 32):
        if admission not in ADMISSIONS:
            raise ValueError(f"unknown admission policy {admission!r} "
                             f"(choices: {ADMISSIONS})")
        if backend not in capsnet.BACKENDS:
            raise ValueError(f"unknown backend {backend!r}")
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.slots = slots
        if plan is None and backend == "kernels":
            plan = compile_plan(cfg, batch=slots, pipeline=True)
        elif plan is not None and plan.batch < slots:
            raise PlanError(
                f"plan compiled for batch {plan.batch} cannot serve {slots} "
                f"slots: every tick runs the full {slots}-row slot batch; "
                f"compile the plan with batch >= slots")
        self.plan = plan
        self.max_queue = max_queue
        self.admission = admission
        self.max_retries = max_retries
        self.retry_backoff_ticks = retry_backoff_ticks
        self.quarantine_after = quarantine_after
        self.breaker_after = breaker_after
        self.probation_ticks = probation_ticks
        self.stall_ticks = stall_ticks
        self.degraded = False            # breaker tripped or plan degraded
        self.degrade_report = None       # execplan.DegradeReport after replan
        self.quarantined: set[int] = set()
        self.active: list[CapsRequest | None] = [None] * slots
        self.queue: deque[CapsRequest] = deque()
        self.finished: list[CapsRequest] = []
        self.ticks = 0
        self._backend = backend
        self._occupancy = 0
        self._now = time.perf_counter    # injectable clock (deadline tests)
        self._started_s: float | None = None
        self._stopped_s: float | None = None
        self._smem_budget = (plan.smem_budget if plan is not None
                             else SMEM_BYTES)
        self._orig_budget = self._smem_budget
        self._counters = {s: 0 for s in TERMINAL_STATUSES}
        self._counters.update(submitted=0, retries=0, replans=0,
                              breaker_trips=0, forward_failures=0,
                              poisoned=0, unquarantined=0)
        # Terminals of requests that never reached a slot; the rest of
        # each aggregate is the (one) shard's.
        self._queue_counters = {s: 0 for s in TERMINAL_STATUSES}
        self._poison_streak = [0] * slots   # consecutive bad results / slot
        self._backoff_until = [0] * slots   # tick a retrying slot resumes at
        self._breaker_fails = 0             # consecutive dispatch exceptions
        self._clean_streak = 0              # ticks since the last poison
        self._stall_pending = False         # injected stall: skip one tick
        self._batch = np.zeros(
            (slots, cfg.image_hw, cfg.image_hw, cfg.in_channels), np.float32)
        self._batch_dev = torch.zeros(self._batch.shape, device=self.device)
        self._dirty: set[int] = set()    # slots to upload before a forward
        self._forward_builds = 0         # forwards built and dispatched
        self._forward = self._make_forward(backend)

    def _make_forward(self, backend: str):
        """The forward over the full slot batch on ``self.plan``, returning
        the lengths and predictions of the slots ``idx`` (a list).  Rebuilt
        only when the serving path changes (a replan swaps the plan, the
        breaker the backend); ``_forward_builds`` counts it at its first
        dispatch."""
        built = False

        def fwd(params, images, idx):
            nonlocal built
            if not built:
                built = True
                self._forward_builds += 1
            with torch.no_grad():
                out = capsnet.forward(params, images, self.cfg,
                                      backend=backend, plan=self.plan,
                                      device=self.device)
            lengths = out["lengths"][idx].cpu().numpy()
            return lengths, np.argmax(lengths, axis=-1)

        return fwd

    # -- admission -------------------------------------------------------
    def _finish(self, req: CapsRequest, status: str,
                in_slot: bool = False) -> None:
        """Assign the terminal ``status``; every submitted request passes
        through here exactly once.  A terminal not ``in_slot`` goes to
        the queue bucket as well."""
        req.status = status
        req.finished_s = self._now()
        self.finished.append(req)
        self._counters[status] += 1
        if not in_slot:
            self._queue_counters[status] += 1

    def submit(self, req: CapsRequest) -> None:
        """Queue ``req``.  Rejects an image whose layout is not the
        engine's [H, W, C]; a full bounded queue sheds per the admission
        policy (a terminal ``"shed"`` status, never a raise)."""
        img = np.asarray(req.image, np.float32)
        want = self._batch.shape[1:]
        if img.shape != want:
            raise ValueError(
                f"request {req.rid}: image shape {img.shape} does not match "
                f"the engine input shape {want} (H, W, C); refusing to "
                f"reshape")
        req.image = img
        req.submitted_s = self._now()
        self._counters["submitted"] += 1
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            if self.admission == "reject":
                self._finish(req, "shed")            # the newcomer pays
                return
            self._finish(self.queue.popleft(), "shed")   # the oldest pays
        self.queue.append(req)

    def _admit(self) -> None:
        for s in range(self.slots):
            if s in self.quarantined:
                continue
            if self.active[s] is None and self.queue:
                req = self.queue.popleft()
                self._batch[s] = req.image
                self._dirty.add(s)
                self.active[s] = req

    def _clear_slot(self, s: int) -> None:
        self.active[s] = None
        self._batch[s] = 0.0
        self._dirty.add(s)               # a freed slot returns to zeros
        self._backoff_until[s] = 0

    def _upload_dirty(self) -> None:
        """Copy only the slots dirtied since the last tick to the device."""
        dirty = sorted(self._dirty)
        self._dirty.clear()
        rows = torch.from_numpy(self._batch[dirty]).to(self.device)
        self._batch_dev.index_copy_(
            0, torch.tensor(dirty, device=self.device), rows)

    # -- fault reactions -------------------------------------------------
    def _apply_tick_faults(self, tick: int) -> None:
        for spec in faults.poll(faults.SITE_ENGINE_TICK, index=tick):
            if spec.kind == "vmem_shrink":
                self._replan(spec.factor)
            elif spec.kind == "slot_corrupt":
                self._corrupt_slot(spec, tick)
            elif spec.kind == "stall":
                self._stall_pending = True

    def _replan(self, factor: float) -> None:
        """React to a shrunk shared-memory budget at a tick boundary: swap
        in the degraded plan (the device slot batch kept); trip the
        breaker when not even a degraded plan fits.  Idempotent across a
        multi-tick fault window: the factor scales the ORIGINAL budget."""
        new_budget = max(int(self._orig_budget * factor), 1)
        if new_budget == self._smem_budget:
            return
        self._smem_budget = new_budget
        if self._backend != "kernels":
            return                       # the plain path plans nothing
        try:
            plan, report = execplan.degrade_plan(
                self.cfg, new_budget, batch=self.slots, pipeline=True)
        except PlanError:
            self._trip_breaker()         # not even degraded fits: plain
            return
        if plan == self.plan:
            return                       # the shrunk budget fits as it is
        self.plan = plan
        self.degrade_report = report
        self.degraded = self.degraded or report.degraded
        self._counters["replans"] += 1
        self._forward = self._make_forward("kernels")
        self._lift_quarantine()          # new plan: a fresh chance

    def _corrupt_slot(self, spec: faults.FaultSpec, tick: int) -> None:
        """NaN-fill one seeded ACTIVE slot's device row.  The host copy
        stays clean, so the retry path's upload heals it."""
        act = [s for s in range(self.slots) if self.active[s] is not None]
        if not act:
            return
        rng = np.random.default_rng(spec.seed + tick)
        s = act[int(rng.integers(len(act)))]
        if self._dirty:
            self._upload_dirty()    # land pending admissions first, or the
        self._batch_dev[s] = float("nan")   # dispatch upload erases the NaN

    def _trip_breaker(self) -> None:
        if self._backend == "torch":
            return                       # already on the plain path
        self._backend = "torch"
        self.plan = None
        self.degraded = True
        self._counters["breaker_trips"] += 1
        self._breaker_fails = 0
        self._forward = self._make_forward("torch")
        self._lift_quarantine()          # new backend: a fresh chance

    def _lift_quarantine(self) -> None:
        """Return quarantined slots to the admission pool with their
        poison streaks reset: after ``probation_ticks`` clean ticks, and
        on a breaker trip or plan swap (the serving path changed)."""
        if not self.quarantined:
            return
        for s in self.quarantined:
            self._poison_streak[s] = 0
        self._counters["unquarantined"] += len(self.quarantined)
        self.quarantined.clear()
        self._clean_streak = 0

    def _maybe_lift_quarantine(self) -> None:
        if (self.probation_ticks is not None and self.quarantined
                and self._clean_streak >= self.probation_ticks):
            self._lift_quarantine()

    def _expired(self, req: CapsRequest) -> bool:
        return (req.deadline_s is not None
                and self._now() - req.submitted_s > req.deadline_s)

    def _sweep_deadlines(self, now: float) -> None:
        for req in [r for r in self.queue
                    if r.deadline_s is not None
                    and now - r.submitted_s > r.deadline_s]:
            self.queue.remove(req)
            self._finish(req, "timeout")
        for s, req in enumerate(self.active):
            if (req is not None and req.deadline_s is not None
                    and now - req.submitted_s > req.deadline_s):
                self._finish(req, "timeout", in_slot=True)
                self._clear_slot(s)

    # -- main loop -------------------------------------------------------
    def _end_tick(self, act_count: int, poisoned: bool = False) -> None:
        for waiting in self.queue:
            waiting.queue_ticks += 1
        self.ticks += 1
        self._occupancy += act_count
        self._clean_streak = 0 if poisoned else self._clean_streak + 1
        self._stopped_s = self._now()

    def step(self) -> int:
        """One tick: deadline sweep, admission, tick faults, then one
        forward over the slot batch.  Returns the number of requests that
        ended ``ok``."""
        if self._started_s is None:
            self._started_s = self._now()
        self._sweep_deadlines(self._now())
        self._maybe_lift_quarantine()
        self._admit()
        # Tick faults land after admission (slot_corrupt sees this tick's
        # rows) and before dispatch (a replan swaps the plan between
        # forwards, never inside one).
        if faults.enabled():
            self._apply_tick_faults(self.ticks)
        if self._stall_pending:
            # Injected stall: the tick passes with no dispatch (run()'s
            # progress check is the guard).
            self._stall_pending = False
            self._end_tick(0)
            return 0
        if self.queue and len(self.quarantined) == self.slots:
            # Every slot is quarantined: the backlog can never be served.
            while self.queue:
                self._finish(self.queue.popleft(), "shed")
        act = [s for s in range(self.slots)
               if self.active[s] is not None
               and self._backoff_until[s] <= self.ticks]
        if not act:
            if any(a is not None for a in self.active) or self.queue:
                self._end_tick(0)        # backed-off slots need time to pass
            return 0
        if self._dirty:
            self._upload_dirty()
        try:
            if faults.enabled() and faults.poll(
                    faults.SITE_ENGINE_FORWARD, index=self.ticks,
                    kinds=("plan_error",)):
                raise PlanError(
                    f"injected plan_error at {faults.SITE_ENGINE_FORWARD} "
                    f"(tick {self.ticks})")
            lengths, preds = self._forward(self.params, self._batch_dev,
                                           act)
            self._breaker_fails = 0
        except PlanError:
            # A plan failure loses one tick, never the engine: consecutive
            # ones trip the breaker onto the plain path.  Anything else (a
            # kernel that does not build or launch) propagates.
            self._counters["forward_failures"] += 1
            self._breaker_fails += 1
            if self._breaker_fails >= self.breaker_after:
                self._trip_breaker()
            self._end_tick(0)
            return 0
        if faults.enabled():
            for spec in faults.poll(faults.SITE_ENGINE_FORWARD,
                                    index=self.ticks,
                                    kinds=("nan_output", "inf_output")):
                fill = np.nan if spec.kind == "nan_output" else np.inf
                lengths = np.full_like(lengths, fill)
        done = 0
        poisoned_tick = False
        for row, pred, s in zip(lengths, preds, act):
            req = self.active[s]
            if not np.all(np.isfinite(row)):
                poisoned_tick = True
                self._counters["poisoned"] += 1
                self._poison_streak[s] += 1
                if self._poison_streak[s] >= self.quarantine_after:
                    # K consecutive poisoned results through one slot:
                    # quarantine it (probation may lift it), error out.
                    self.quarantined.add(s)
                    self._finish(req, "error", in_slot=True)
                    self._clear_slot(s)
                elif self._expired(req):
                    # The deadline passed in retry backoff: no further
                    # dispatch for a dead request.
                    self._finish(req, "timeout", in_slot=True)
                    self._clear_slot(s)
                elif req.retries < self.max_retries:
                    req.retries += 1
                    self._counters["retries"] += 1
                    # Backoff grows with the retry count; the clean host
                    # image is uploaded again (heals device corruption).
                    self._backoff_until[s] = (self.ticks + 1
                                              + self.retry_backoff_ticks
                                              * req.retries)
                    self._batch[s] = req.image
                    self._dirty.add(s)
                else:
                    self._finish(req, "error", in_slot=True)
                    self._clear_slot(s)
                continue
            self._poison_streak[s] = 0
            req.lengths = row
            req.pred = int(pred)
            self._finish(req, "ok", in_slot=True)
            self._clear_slot(s)
            done += 1
        self._end_tick(len(act), poisoned=poisoned_tick)
        return done

    def run(self, max_ticks: int | None = None) -> list[CapsRequest]:
        """Drive ticks until every request is terminal."""
        no_progress = 0
        while self.queue or any(a is not None for a in self.active):
            before = len(self.finished)
            self.step()
            no_progress = (0 if len(self.finished) > before
                           else no_progress + 1)
            pending = (len(self.queue)
                       + sum(a is not None for a in self.active))
            if pending and no_progress >= self.stall_ticks:
                raise EngineStalled(
                    f"no request reached a terminal status in "
                    f"{no_progress} consecutive ticks with {pending} "
                    f"pending (tick {self.ticks}); the engine is stalled")
            if max_ticks is not None and self.ticks >= max_ticks and pending:
                raise EngineStalled(
                    f"max_ticks={max_ticks} exhausted with {pending} "
                    f"requests still pending")
        return self.finished

    # -- reporting -------------------------------------------------------
    def stats(self) -> dict:
        n = len(self.finished)
        elapsed = ((self._stopped_s - self._started_s)
                   if self._started_s is not None
                   and self._stopped_s is not None else 0.0)
        lats = [r.latency_s for r in self.finished if r.latency_s is not None]
        per_shard = [dict(shard=0, slots=self.slots,
                          occupied=sum(a is not None for a in self.active),
                          quarantined=len(self.quarantined),
                          **{st: self._counters[st] - self._queue_counters[st]
                             for st in TERMINAL_STATUSES})]
        return dict(
            requests=n,
            ticks=self.ticks,
            elapsed_s=elapsed,
            requests_per_s=n / elapsed if elapsed > 0 else 0.0,
            mean_latency_ms=1e3 * float(np.mean(lats)) if lats else 0.0,
            max_latency_ms=1e3 * float(np.max(lats)) if lats else 0.0,
            occupancy=(self._occupancy / (self.ticks * self.slots)
                       if self.ticks else 0.0),
            degraded=self.degraded,
            quarantined=len(self.quarantined),
            smem_budget=self._smem_budget,
            n_shards=1,
            slots_per_shard=self.slots,
            per_shard=per_shard,
            queue_bucket=dict(self._queue_counters),
            **self._counters,
        )


class AsyncCapsuleServer:
    """Asyncio host loop over a ``CapsuleEngine``: continuous slot
    recycling with a future per request.

    ``submit()`` enqueues through the engine (so the bounded-queue
    admission applies unchanged: a shed request's future resolves at once
    with ``status == "shed"``) and awaits the request's terminal status.
    One driver task ticks the engine while work is pending and yields to
    the event loop between ticks, so freed slots refill from whatever was
    submitted meanwhile.  The engine is stepped from the event-loop thread
    only, so nothing needs a lock.  ``EngineStalled`` (or any driver
    failure) reaches every future in flight instead of hanging it.
    """

    def __init__(self, engine: CapsuleEngine, *,
                 idle_sleep_s: float = 1e-3):
        self.engine = engine
        self._idle_sleep_s = idle_sleep_s
        self._waiters: dict[int, asyncio.Future] = {}   # id(req) -> future
        self._task: asyncio.Task | None = None
        self._stopping = False
        self._next_rid = 0
        self._seen = len(engine.finished)

    async def __aenter__(self) -> "AsyncCapsuleServer":
        self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    def start(self) -> None:
        if self._task is None:
            self._stopping = False
            self._task = asyncio.get_running_loop().create_task(
                self._drive())

    async def stop(self) -> None:
        """Drain: the driver ticks until no work is pending, then exits."""
        self._stopping = True
        if self._task is not None:
            await self._task
            self._task = None

    async def submit(self, image, *,
                     deadline_s: float | None = None) -> CapsRequest:
        """Submit one image and await its terminal request."""
        rid = self._next_rid
        self._next_rid += 1
        req = CapsRequest(rid=rid, image=image, deadline_s=deadline_s)
        fut = asyncio.get_running_loop().create_future()
        self._waiters[id(req)] = fut
        self.engine.submit(req)      # may shed at once (admission)
        self._resolve_finished()
        self.start()                 # the driver starts on first use
        return await fut

    def _resolve_finished(self) -> None:
        fin = self.engine.finished
        while self._seen < len(fin):
            req = fin[self._seen]
            self._seen += 1
            fut = self._waiters.pop(id(req), None)
            if fut is not None and not fut.done():
                fut.set_result(req)

    def _pending(self) -> bool:
        eng = self.engine
        return bool(eng.queue) or any(a is not None for a in eng.active)

    async def _drive(self) -> None:
        try:
            while True:
                if self._pending():
                    self.engine.step()
                    self._resolve_finished()
                    await asyncio.sleep(0)   # admit work queued mid-tick
                elif self._stopping:
                    return
                else:
                    await asyncio.sleep(self._idle_sleep_s)
        except BaseException as e:
            for fut in self._waiters.values():
                if not fut.done():
                    fut.set_exception(e)
            self._waiters.clear()
            raise
