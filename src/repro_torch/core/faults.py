"""Deterministic, seeded fault injection: the counterpart of
``repro/core/faults.py``.

One switchboard through which chaos tests inject failures into the real
recovery paths.  Every site guards with ``if faults.enabled():`` (one
global load when nothing is injected).  A ``FaultSpec`` fires on an index
window (``at <= index < at + times``) of an explicit site index (the
training step) or of the site's own poll counter, never on the clock.
``inject(*specs)`` installs a registry for a ``with`` body and always
tears it down; nesting is refused.

Sites wired in the port so far: ``train.step`` (``train/harness.py``:
``nan_output`` / ``inf_output`` poison the step's loss so the NaN
rollback runs, ``stall`` inflates the step's measured time).  The
``ops.*`` and ``engine.*`` names are kept for the sites still to be
wired (the kernel wrappers' outputs, through ``corrupt_array``, and the
engine's ticks).
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict
from typing import Iterator

import torch

KINDS = ("nan_output", "inf_output", "vmem_shrink", "plan_error",
         "slot_corrupt", "stall")

SITE_VOTES_ROUTING = "ops.votes_routing"
SITE_PRIMARY_ROUTING = "ops.primary_routing"
SITE_CONV2D = "ops.conv2d"
SITE_CAPS_VOTES = "ops.caps_votes"
SITE_ROUTING = "ops.routing"
SITE_RES_CAPS_SEGMENT = "ops.res_caps_segment"
SITE_SQUASH = "ops.squash"
SITE_RMSNORM = "ops.rmsnorm"
SITE_FLASH_ATTENTION = "ops.flash_attention"
SITE_ENGINE_TICK = "engine.tick"
SITE_ENGINE_FORWARD = "engine.forward"
SITE_TRAIN_STEP = "train.step"


class InjectionError(RuntimeError):
    """Misuse of the injection machinery itself (nested ``inject``,
    unknown kind), never raised by a fired fault."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """Fire ``kind`` at ``site`` for the index window ``[at, at + times)``;
    ``times=0`` never fires.  ``factor`` scales the shared-memory budget
    for ``vmem_shrink``, ``seconds`` is what a ``stall`` adds to a step's
    measured time, ``seed`` drives any random choice of the firing."""

    site: str
    kind: str
    at: int = 0
    times: int = 1
    factor: float = 0.5
    seconds: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise InjectionError(
                f"unknown fault kind {self.kind!r} (kinds: {KINDS})")
        if self.times < 0:
            raise InjectionError(f"times must be >= 0, got {self.times}")
        if self.kind == "vmem_shrink" and not 0.0 < self.factor <= 1.0:
            raise InjectionError(
                f"vmem_shrink factor must be in (0, 1], got {self.factor}")

    def fires_at(self, index: int) -> bool:
        return self.times > 0 and self.at <= index < self.at + self.times


class FaultRegistry:
    """The active specs and a log (``fired``) of ``(site, kind, index)``
    for every firing."""

    def __init__(self, specs: tuple[FaultSpec, ...]):
        self.specs = tuple(specs)
        self.fired: list[tuple[str, str, int]] = []
        self._counters: defaultdict[str, int] = defaultdict(int)

    def poll(self, site: str, *, index: int | None = None,
             kinds: tuple[str, ...] | None = None) -> tuple[FaultSpec, ...]:
        if index is None:
            index = self._counters[site]
            self._counters[site] += 1
        hits = tuple(s for s in self.specs
                     if s.site == site and s.fires_at(index)
                     and (kinds is None or s.kind in kinds))
        self.fired.extend((site, s.kind, index) for s in hits)
        return hits

    def count(self, site: str | None = None,
              kind: str | None = None) -> int:
        """Number of recorded firings, optionally filtered."""
        return sum(1 for (s, k, _) in self.fired
                   if (site is None or s == site)
                   and (kind is None or k == kind))


_ACTIVE: FaultRegistry | None = None


def enabled() -> bool:
    """True iff an ``inject`` context is active."""
    return _ACTIVE is not None


def registry() -> FaultRegistry | None:
    return _ACTIVE


@contextlib.contextmanager
def inject(*specs: FaultSpec) -> Iterator[FaultRegistry]:
    """Activate ``specs`` for the ``with`` body; always tears down."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise InjectionError(
            "fault injection is already active; nested inject() would make "
            "the fired log ambiguous -- compose specs into one registry")
    reg = FaultRegistry(specs)
    _ACTIVE = reg
    try:
        yield reg
    finally:
        _ACTIVE = None


def poll(site: str, *, index: int | None = None,
         kinds: tuple[str, ...] | None = None) -> tuple[FaultSpec, ...]:
    """Site-level poll: () when injection is disabled."""
    reg = _ACTIVE
    if reg is None:
        return ()
    return reg.poll(site, index=index, kinds=kinds)


def corrupt_array(site: str, x: torch.Tensor) -> torch.Tensor:
    """Kernel-wrapper site: ``x`` poisoned (all NaN / all Inf) when an
    output fault fires, ``PlanError`` on ``plan_error``, else ``x`` itself.
    Advances the site's poll counter once per call."""
    reg = _ACTIVE
    if reg is None:
        return x
    hits = reg.poll(site, kinds=("nan_output", "inf_output", "plan_error"))
    for spec in hits:
        if spec.kind == "plan_error":
            from repro_torch.core.execplan import PlanError
            raise PlanError(f"injected plan_error at {site}")
    for spec in hits:
        fill = float("nan") if spec.kind == "nan_output" else float("inf")
        return torch.full_like(x, fill)
    return x
