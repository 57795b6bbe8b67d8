"""Fault-tolerant training-loop skeleton: the counterpart of
``repro/train/harness.py``.

A template method (``run``) with async atomic checkpoints, resume from
the latest committed step, NaN/divergence rollback to THIS run's last
committed step, a JSON heartbeat, a preemption save and straggler
detection.  Subclasses supply the model's hooks:

  * ``_init_state()``        -> checkpoint-shaped state dict
  * ``_next_batch(step)``    -> batch for this step
  * ``_run_step(state, b)``  -> (new state dict, metrics with "loss")
  * ``_extra_record(m)``     -> extra per-step history fields
  * ``_log_line(rec)``       -> the periodic progress line
  * ``_ckpt_extra()``        -> manifest extras (backend, optimizer, ...)
  * ``_skip_batch(step)``    -> advance a stateful data stream past a
                               poisoned batch (stateless data: no-op)
  * ``_begin(start)``        -> once a run, after the restore, before the
                               first step (the LM loop starts its data
                               stream at ``start``)
  * ``_shardings()``         -> placements for a restore (the sharded LM
                               loop's elastic restore), None by default

State is always the checkpoint dict (``{"params": ...}`` or
``{"params": ..., "opt": ...}``), a nested dict of tensors.
``_run_step`` dispatches through ``self._step_fn`` at call time, so tests
may replace ``loop._step_fn`` after the loop is built.  The loop config
is duck-typed: any object with ``total_steps, ckpt_every, ckpt_dir,
keep, log_every, heartbeat_path, max_nan_skips`` (and optionally
``straggler_factor``).  Step times are host-clock times of a step that
ends in reading its loss, which waits for the device.
"""

from __future__ import annotations

import json
import os
import pathlib
import signal
import time
from typing import Callable

import numpy as np

from repro_torch.core import faults
from repro_torch.train import checkpoint as ckpt


class FaultTolerantLoop:
    """Template-method base for checkpointed, NaN-guarded training."""

    def __init__(self, loop_cfg,
                 on_straggler: Callable[[int, float], None] | None = None):
        self.loop_cfg = loop_cfg
        self.on_straggler = on_straggler or (lambda step, t: None)
        self._stop = False
        self.step = 0
        self.nan_skips = 0               # lifetime count (reporting)
        self._nan_streak = 0             # CONSECUTIVE count (the bound)
        self._last_committed = 0         # latest step THIS run checkpointed
        self.history: list[dict] = []
        self._times: list[float] = []
        self.checkpointer = ckpt.AsyncCheckpointer(loop_cfg.ckpt_dir,
                                                   keep=loop_cfg.keep)

    # -- lifecycle ------------------------------------------------------------
    def request_stop(self, *_args) -> None:
        self._stop = True

    def install_signal_handler(self) -> None:       # pragma: no cover
        signal.signal(signal.SIGTERM, self.request_stop)

    # -- hooks (subclass responsibilities) ------------------------------------
    def _init_state(self) -> dict:
        raise NotImplementedError

    def _next_batch(self, step: int):
        raise NotImplementedError

    def _run_step(self, state: dict, batch) -> tuple[dict, dict]:
        raise NotImplementedError

    def _extra_record(self, metrics: dict) -> dict:
        return {}

    def _log_line(self, rec: dict) -> str:
        return (f"step {rec['step']:6d} loss {rec['loss']:9.4f} "
                f"{rec['time_s'] * 1e3:7.1f} ms")

    def _ckpt_extra(self) -> dict:
        return {}

    def _skip_batch(self, step: int) -> None:
        """Advance a stateful data stream to ``step`` (data indexed by
        step needs nothing here)."""

    def _shardings(self):
        """Placements of the state's leaves for a restore (a tree of
        ``parallel.sharding.NamedSharding``), None for as they were."""
        return None

    def _begin(self, start: int) -> None:
        """Called once a ``run``, after the restore and before the first
        step."""

    # -- shared machinery -----------------------------------------------------
    def _try_restore(self, state: dict) -> tuple[dict, int]:
        if ckpt.latest_step(self.loop_cfg.ckpt_dir) is None:
            return state, 0
        restored, manifest = ckpt.restore(state, self.loop_cfg.ckpt_dir,
                                          shardings=self._shardings())
        return restored, manifest["step"]

    def _restore_committed(self) -> dict:
        """Roll back to THIS run's last committed checkpoint (a shared
        ckpt_dir may hold later steps of an abandoned run)."""
        restored, _ = ckpt.restore(self._init_state(),
                                   self.loop_cfg.ckpt_dir,
                                   step=self._last_committed,
                                   shardings=self._shardings())
        return restored

    def _heartbeat(self, step: int, metrics: dict) -> None:
        if self.loop_cfg.heartbeat_path is None:
            return
        hb = {"step": step, "time": time.time(),
              "loss": float(metrics.get("loss", np.nan))}
        p = pathlib.Path(self.loop_cfg.heartbeat_path)
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_name(p.name + ".tmp")
        tmp.write_text(json.dumps(hb))
        os.replace(tmp, p)

    def _note_time(self, dt: float) -> None:
        self._times.append(dt)
        factor = getattr(self.loop_cfg, "straggler_factor", None)
        if factor is None:
            return
        med = float(np.median(self._times[-21:]))
        if len(self._times) > 5 and dt > factor * med:
            self.on_straggler(self.step, dt)

    def _apply_step_faults(self, loss: float, dt: float) -> tuple[float,
                                                                  float]:
        """Chaos-test site ``train.step`` (index = the step about to
        finish): ``nan_output`` / ``inf_output`` poison the loss so the
        rollback runs for real; ``stall`` adds ``seconds`` to the step's
        measured time."""
        for spec in faults.poll(faults.SITE_TRAIN_STEP, index=self.step):
            if spec.kind == "nan_output":
                loss = float("nan")
            elif spec.kind == "inf_output":
                loss = float("inf")
            elif spec.kind == "stall":
                dt += spec.seconds
        return loss, dt

    def _save(self, state: dict, step: int) -> None:
        self.checkpointer.save_async(state, step, extra=self._ckpt_extra())
        self._last_committed = step

    # -- main -----------------------------------------------------------------
    def run(self, resume: bool = True) -> list[dict]:
        state = self._init_state()
        start = 0
        if resume:
            state, start = self._try_restore(state)
        if start == 0:
            ckpt.save(state, self.loop_cfg.ckpt_dir, 0,
                      extra=self._ckpt_extra())
        self._begin(start)
        self.step = start
        self._last_committed = start
        self._times = []

        while self.step < self.loop_cfg.total_steps and not self._stop:
            batch = self._next_batch(self.step)
            t0 = time.perf_counter()
            state, metrics = self._run_step(state, batch)
            loss = float(metrics["loss"])       # waits for the device
            dt = time.perf_counter() - t0
            if faults.enabled():
                loss, dt = self._apply_step_faults(loss, dt)

            if not np.isfinite(loss):
                self.nan_skips += 1
                self._nan_streak += 1
                if self._nan_streak > self.loop_cfg.max_nan_skips:
                    raise RuntimeError(
                        f"diverged: {self._nan_streak} consecutive "
                        f"non-finite steps (> max_nan_skips="
                        f"{self.loop_cfg.max_nan_skips})")
                self.checkpointer.wait()
                state = self._restore_committed()
                self._skip_batch(self.step + 1)   # drop the poisoned batch
                self.step += 1
                continue

            self._nan_streak = 0
            self._note_time(dt)
            self.step += 1
            rec = {"step": self.step, "loss": loss, "time_s": dt,
                   **self._extra_record(metrics)}
            self.history.append(rec)
            self._heartbeat(self.step, metrics)
            if self.step % self.loop_cfg.log_every == 0:
                print(self._log_line(rec), flush=True)
            if self.step % self.loop_cfg.ckpt_every == 0 \
                    or self.step == self.loop_cfg.total_steps:
                self._save(state, self.step)

        if self._stop:   # preemption: commit state before exiting
            self.checkpointer.wait()
            ckpt.save(state, self.loop_cfg.ckpt_dir, self.step,
                      extra={**self._ckpt_extra(), "preempted": True})
        self.checkpointer.wait()
        return self.history
