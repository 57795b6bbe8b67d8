"""Slot-based batched CapsuleNet inference engine: the core of
``repro/serve/capsule.py``'s ``CapsuleEngine`` in PyTorch.

A fixed number of batch slots share one plan-driven forward.  Each tick
fills free slots from the queue and runs the whole slot batch through
the forward once, so the ExecutionPlan is compiled once (``pipeline=True``
on the kernels backend) and amortized across the request stream.
Inactive slots hold zero images; the capsule head is per-sample, so they
never perturb active requests.

The slot batch lives on the device, and only the slots dirtied since the
last tick (admissions, and freed slots returning to zeros) are uploaded.
Every request ends in exactly one terminal ``status``: ``ok``;
``timeout`` when its ``deadline_s`` expires in the queue or in a slot;
``error`` when its capsule lengths come back non-finite (the reference
engine with ``max_retries=0``); ``shed`` when the bounded queue
(``max_queue``) is full -- ``admission="reject"`` sheds the newcomer,
``"shed-oldest"`` the head of the queue.  ``run`` raises
``EngineStalled`` after ``stall_ticks`` ticks without a terminal event
while work is pending, or when ``max_ticks`` runs out.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.core import capsnet
from repro_torch.core.capsnet import CapsNetConfig
from repro_torch.core.execplan import compile_plan
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
                 max_queue: int | None = None, admission: str = "reject",
                 stall_ticks: int = 32):
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
        self.backend = backend
        self.plan = (compile_plan(cfg, batch=slots, pipeline=True)
                     if backend == "kernels" else None)
        self.max_queue = max_queue
        self.admission = admission
        self.stall_ticks = stall_ticks
        self.active: list[CapsRequest | None] = [None] * slots
        self.queue: deque[CapsRequest] = deque()
        self.finished: list[CapsRequest] = []
        self.ticks = 0
        self._occupancy = 0
        self._now = time.perf_counter    # injectable clock (deadline tests)
        self._started_s: float | None = None
        self._stopped_s: float | None = None
        self._counters = {s: 0 for s in TERMINAL_STATUSES}
        self._counters["submitted"] = 0
        self._batch = np.zeros(
            (slots, cfg.image_hw, cfg.image_hw, cfg.in_channels), np.float32)
        self._batch_dev = torch.zeros(self._batch.shape, device=self.device)
        self._dirty: set[int] = set()    # slots to upload before a forward

    # -- admission -------------------------------------------------------
    def _finish(self, req: CapsRequest, status: str) -> None:
        """Every submitted request passes through here exactly once."""
        req.status = status
        req.finished_s = self._now()
        self.finished.append(req)
        self._counters[status] += 1

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
            if self.active[s] is None and self.queue:
                req = self.queue.popleft()
                self._batch[s] = req.image
                self._dirty.add(s)
                self.active[s] = req

    def _clear_slot(self, s: int) -> None:
        self.active[s] = None
        self._batch[s] = 0.0
        self._dirty.add(s)               # a freed slot returns to zeros

    def _upload_dirty(self) -> None:
        """Copy only the slots dirtied since the last tick to the device."""
        dirty = sorted(self._dirty)
        self._dirty.clear()
        rows = torch.from_numpy(self._batch[dirty]).to(self.device)
        self._batch_dev.index_copy_(
            0, torch.tensor(dirty, device=self.device), rows)

    def _sweep_deadlines(self, now: float) -> None:
        for req in [r for r in self.queue
                    if r.deadline_s is not None
                    and now - r.submitted_s > r.deadline_s]:
            self.queue.remove(req)
            self._finish(req, "timeout")
        for s, req in enumerate(self.active):
            if (req is not None and req.deadline_s is not None
                    and now - req.submitted_s > req.deadline_s):
                self._finish(req, "timeout")
                self._clear_slot(s)

    # -- main loop -------------------------------------------------------
    def step(self) -> int:
        """One tick: deadline sweep, admission, then one forward over the
        slot batch.  Returns the number of requests that ended ``ok``."""
        if self._started_s is None:
            self._started_s = self._now()
        self._sweep_deadlines(self._now())
        self._admit()
        act = [s for s in range(self.slots) if self.active[s] is not None]
        if not act:
            return 0
        if self._dirty:
            self._upload_dirty()
        with torch.no_grad():
            out = capsnet.forward(self.params, self._batch_dev, self.cfg,
                                  backend=self.backend, plan=self.plan,
                                  device=self.device)
        lengths = out["lengths"][act].cpu().numpy()
        done = 0
        for row, s in zip(lengths, act):
            req = self.active[s]
            if not np.all(np.isfinite(row)):
                self._finish(req, "error")
            else:
                req.lengths = row
                req.pred = int(np.argmax(row))
                self._finish(req, "ok")
                done += 1
            self._clear_slot(s)
        for waiting in self.queue:
            waiting.queue_ticks += 1
        self.ticks += 1
        self._occupancy += len(act)
        self._stopped_s = self._now()
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
        return dict(
            requests=n,
            ticks=self.ticks,
            elapsed_s=elapsed,
            requests_per_s=n / elapsed if elapsed > 0 else 0.0,
            mean_latency_ms=1e3 * float(np.mean(lats)) if lats else 0.0,
            max_latency_ms=1e3 * float(np.max(lats)) if lats else 0.0,
            occupancy=(self._occupancy / (self.ticks * self.slots)
                       if self.ticks else 0.0),
            **self._counters,
        )
