"""The program's spans and samples, recorded only under ``torch.profiler``.

A ``torch.profiler`` session is the one switch.  With none active,
``span(name)`` checks the profiler's enabled flag and hands back a shared
no-op context: no ``record_function``, no clock, nothing allocated.
Under a session a span enters ``torch.profiler.record_function(name)``,
so the profiler stamps the range on the clock of its device records and
``export_chrome_trace`` shows it, and this module keeps, in memory, one
``Span(id, name, parent, start_ns, end_ns)`` per instance (``parent`` is
the id of the span it nests in on the same thread, or None; the times
are ``time.time_ns()``, the clock the profiler's events carry).
``sample(name, value)`` keeps one value of a distribution under the same
switch.  ``snapshot()`` returns what this process recorded, ``reset()``
clears it; there is no exporter of its own.

Spans of the program (``serve/capsule.py``, ``core/capsnet.py``):

- ``engine.step``, one ``CapsuleEngine`` tick, holding in order
  ``engine.sweep`` (deadlines, quarantine lift), ``engine.admit``,
  ``engine.upload``, ``engine.dispatch`` (every shard's forward
  launched), ``engine.readback`` (lengths to the host: where the host
  waits for the card) and ``engine.finish`` (the per-request loop);
- ``plan.<op name>``, one per ``ExecutionPlan`` op of the kernels
  forward, and ``model.decode`` around the decoder;
- ``train.step``, holding ``train.forward``, ``train.backward`` and
  ``train.update`` (the in-place SGD).

Samples: ``engine.queue_wait_s``, each admitted request's seconds from
``submit`` to its slot.

Only the thread that started the session records: the profiler's
enabled flag is thread-local.  Records grow with the session; a
caller that profiles for long calls ``reset()`` between reads.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple

import torch

_enabled = torch._C._autograd._profiler_enabled


class Span(NamedTuple):
    id: int
    name: str
    parent: int | None
    start_ns: int
    end_ns: int


class Snapshot(NamedTuple):
    spans: list[Span]                  # in the order they ended
    samples: dict[str, list[float]]


_spans: list[Span] = []
_samples: dict[str, list[float]] = {}
_ids = itertools.count()
_local = threading.local()


class _Off:
    """The span handed out with no profiler session: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "id", "parent", "start", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self.rf.__exit__(*exc)
        _local.stack.pop()
        _spans.append(Span(self.id, self.name, self.parent, self.start, end))
        return False


def recording() -> bool:
    """Whether a profiler session is active on this thread."""
    return _enabled()


def span(name: str, part: str = ""):
    """A context that records the span ``name + part`` under a profiler
    session (the two are joined only then) and does nothing otherwise."""
    if not _enabled():
        return _OFF
    return _On(name + part if part else name)


def sample(name: str, value: float) -> None:
    """Keep ``value`` as one sample of ``name`` under a profiler session."""
    if _enabled():
        _samples.setdefault(name, []).append(float(value))


def snapshot() -> Snapshot:
    """The spans and samples recorded in this process since ``reset()``."""
    return Snapshot(list(_spans), {k: list(v) for k, v in _samples.items()})


def reset() -> None:
    _spans.clear()
    _samples.clear()


def self_ns(spans: list[Span]) -> dict[int, int]:
    """Each span's self time: its duration less its children's."""
    out = {s.id: s.end_ns - s.start_ns for s in spans}
    for s in spans:
        if s.parent in out:
            out[s.parent] -= s.end_ns - s.start_ns
    return out
