"""Op-level analysis of one call: the counterpart of
``repro/launch/hlo_analysis.py``.

The reference reads flops, HBM bytes and collective bytes off the
optimized HLO text with loop trip counts propagated.  The port has no
HLO: ``analyze_ops(fn, *args)`` runs ``fn`` once under a
``TorchDispatchMode`` and counts the aten ops that actually run on its
inputs (real tensors or ``device="meta"`` stand-ins).  A Python loop runs
its ops each time, so there are no trip counts to propagate.

  * FLOPs       -- ``torch.utils.flop_counter``'s formulas (mm, bmm,
                   addmm, baddbmm, convolution, SDPA where it runs): the
                   counterpart of the reference's dot and convolution
                   count, and equal to ``FlopCounterMode`` on the same
                   call.  Ops without a formula that ``FlopCounterMode``
                   would decompose are decomposed the same way.
  * HBM bytes   -- per-op model: every op reads each tensor input and
                   writes each output once, fused or not.  Views
                   (``view``, ``t``, ``expand``, ``as_strided``,
                   ``detach``, ``slice`` ...) and allocations count 0, as
                   the reference's bitcast / tuple / parameter ops do.  An
                   in-place write into a slice counts twice the slice
                   (``copy_``, ``index_put_``: a KV cache write), the
                   counterpart of ``dynamic-update-slice``.  The reference
                   counts a fusion once; this model counts each op of an
                   eager chain, so it over-counts against a fused program
                   (an elementwise chain of n ops is n reads and writes,
                   not one).
  * collectives -- each ``_c10d_functional`` / ``c10d`` collective the
                   call runs (DTensor's redistributions and explicit
                   ``parallel.compat`` calls alike), counted by type and
                   ring-accounted per device (``roofline.collective_moved``)
                   with S the size of the process group it runs over: a
                   mesh dim's group.  The counts equal
                   ``CommDebugMode``'s on the same call.

On DTensors the mode lets DTensor dispatch and counts the **local** ops
each rank runs, so every number is per device.  DTensor's sharding
propagation also runs each op once at the global shape on
``FakeTensor``s under ``FakeTensorMode`` to derive the output's metadata;
ops that run while a ``FakeTensorMode`` is on the dispatch stack are
those shadow ops and are not counted.  A ``Partial`` DTensor left in the
call's result is reduced inside the counted region.

``uncounted`` names what ran with work the flops cannot see: ops in
another namespace (a custom op), matmul-like aten ops with no formula,
and the port's CUDA kernels (``kernel:<name>``), which launch through
ctypes below the dispatcher and are read off their launch counters.
"""

from __future__ import annotations

import collections
import dataclasses
import weakref
from typing import Any, Callable

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils import _pytree
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils.flop_counter import flop_registry

from repro_torch.launch.roofline import COLLECTIVES, collective_moved
from repro_torch.parallel import compat

aten = torch.ops.aten

_DOTS = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten._scaled_mm}

# Ops that move no data: aliases and allocations.
_NO_TRAFFIC = {aten._unsafe_view, aten.detach, aten.alias, aten.lift_fresh,
               aten.empty, aten.empty_like, aten.empty_strided,
               aten.new_empty, aten.new_empty_strided}

# In-place writes into a region: twice the region (read-modify-write).
_REGION_WRITES = {aten.copy_: 0, aten.index_put_: 2,
                  aten._index_put_impl_: 2}

# Matmul-like aten ops with no flop formula: never silently uncounted.
_MATMUL_LIKE = {"mv", "addmv", "dot", "vdot", "addbmm", "addr", "_int_mm",
                "_scaled_dot_product_flash_attention_for_cpu",
                "_scaled_dot_product_attention_math",
                "_scaled_dot_product_fused_attention_overrideable"}

# Collective op name -> (type, which tensor is B): "in" the first tensor
# argument, "out" the result (the gathered / scattered shape), "arg0" the
# first argument of an out-style c10d op (its output buffer).
_COLLECTIVE_OPS = {
    "all_reduce": ("all-reduce", "in"),
    "all_reduce_": ("all-reduce", "in"),
    "allreduce_": ("all-reduce", "in"),
    "all_gather_into_tensor": ("all-gather", "out"),
    "_allgather_base_": ("all-gather", "arg0"),
    "reduce_scatter_tensor": ("reduce-scatter", "out"),
    "_reduce_scatter_base_": ("reduce-scatter", "arg0"),
    "all_to_all_single": ("all-to-all", "in"),
    "alltoall_base_": ("all-to-all", "in"),
    "shard_dim_alltoall": ("all-to-all", "in"),      # DTensor's, on CUDA
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d",
                          "_dtensor")
# Bookkeeping of the functional collectives: no data moved.
_COLLECTIVE_BOOKKEEPING = {"wait_tensor", "_wrap_tensor_autograd"}


@dataclasses.dataclass
class OpAnalysis:
    """The reference's ``HLOAnalysis`` fields, per device, plus what the
    counters could not count and the call's peak of live bytes."""

    flops: float
    memory_bytes: float
    collective_bytes: float
    collective_counts: dict[str, float]
    collective_bytes_by_type: dict[str, float]
    dot_count: float
    uncounted: dict[str, int]
    # The device types of every tensor the counted ops made.
    devices: list[str]
    # The largest sum of bytes of storages the call created that were
    # alive at once (inputs excluded); None where storages take no weak
    # reference.
    peak_live_bytes: float | None = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in _pytree.tree_leaves(tree)
            if isinstance(x, torch.Tensor)]


def _in_fake_mode() -> bool:
    return any(isinstance(m, FakeTensorMode)
               for m in _get_current_dispatch_mode_stack())


def _group_size(args) -> int:
    """The participants of a collective: its process group's size (a mesh
    dim's group), read from the group object or resolved from its name."""
    for a in args:
        if isinstance(a, dist.ProcessGroup):
            return a.size()
        if isinstance(a, torch.ScriptObject):      # a c10d op's group
            return dist.ProcessGroup.unbox(a).size()
    names = [a for a in args if isinstance(a, str)]
    if not names:
        raise ValueError(f"a collective with no group among {args!r}")
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(names[-1]).size()


class _Counter(TorchDispatchMode):
    def __init__(self) -> None:
        super().__init__()
        self.flops = 0.0
        self.memory_bytes = 0.0
        self.dot_count = 0
        self.coll_counts = {c: 0 for c in COLLECTIVES}
        self.coll_bytes = {c: 0.0 for c in COLLECTIVES}
        self.uncounted: collections.Counter = collections.Counter()
        self.devices: set[str] = set()
        self.track_live = True
        self.live: dict[int, int] = {}
        self.live_bytes = 0
        self.peak_live = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, compat.DTensor) for t in types):
            return NotImplemented          # DTensor runs the local ops
        if _in_fake_mode():                # sharding propagation's shadow
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry:    # as FlopCounterMode does
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        self._count(func, packet, args, kwargs, out)
        return out

    def _count(self, func, packet, args, kwargs, out) -> None:
        ns = func.namespace
        name = packet.__name__.split(".")[-1]
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
            self.dot_count += packet in _DOTS
        elif ns in _COLLECTIVE_NAMESPACES:
            self._collective(name, args, out)
            return
        elif ns not in ("aten", "prims") or name in _MATMUL_LIKE:
            self.uncounted[f"{ns}.{name}"] += 1
        if func.is_view or packet in _NO_TRAFFIC:
            return
        if packet in _REGION_WRITES:
            self.memory_bytes += 2.0 * _nbytes(args[_REGION_WRITES[packet]])
            return
        outs = _tensors(out)
        self.devices.update(t.device.type for t in outs)
        self.memory_bytes += sum(_nbytes(t) for t in
                                 _tensors((args, kwargs)) + outs)
        if self.track_live and not func._schema.is_mutable:
            for t in outs:                 # new storages only
                self._track(t)

    def _collective(self, name: str, args, out) -> None:
        if name in _COLLECTIVE_BOOKKEEPING:
            return
        if name not in _COLLECTIVE_OPS:
            self.uncounted[f"collective.{name}"] += 1
            return
        kind, which = _COLLECTIVE_OPS[name]
        ref = {"in": lambda: _tensors(args)[0], "out": lambda: out,
               "arg0": lambda: _tensors(args[0])[0]}[which]()
        b = _nbytes(ref)
        self.coll_counts[kind] += 1
        self.coll_bytes[kind] += collective_moved(kind, b, _group_size(args))
        self.memory_bytes += 2.0 * b

    def _track(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self.live:
            return
        n = storage.nbytes()
        try:
            weakref.finalize(storage, self._free, key)
        except TypeError:                  # no weak reference: not tracked
            self.track_live = False
            return
        self.live[key] = n
        self.live_bytes += n
        self.peak_live = max(self.peak_live, self.live_bytes)

    def _free(self, key: int) -> None:
        self.live_bytes -= self.live.pop(key, 0)


def _reduce_partials(out: Any) -> None:
    """Trigger the lazy reduction of every ``Partial`` DTensor in ``out``
    (its all-reduce is part of the call's communication)."""
    for x in _pytree.tree_leaves(out):
        if compat.is_dtensor(x) and any(p.is_partial()
                                        for p in x.placements):
            x.redistribute(x.device_mesh, [
                compat.Replicate() if p.is_partial() else p
                for p in x.placements])


def _kernel_launches() -> dict[str, int]:
    from repro_torch.kernels import build
    return build.launch_counts()


def analyze_ops(fn: Callable, *args, **kwargs) -> tuple[Any, OpAnalysis]:
    """``(fn(*args, **kwargs), its OpAnalysis)``: ``fn`` run once under
    the counters (module docstring)."""
    before = _kernel_launches()
    counter = _Counter()
    with counter:
        out = fn(*args, **kwargs)
        _reduce_partials(out)
    uncounted = dict(counter.uncounted)
    for name, n in _kernel_launches().items():
        if n > before.get(name, 0):
            uncounted[f"kernel:{name}"] = n - before.get(name, 0)
    return out, OpAnalysis(
        flops=counter.flops, memory_bytes=counter.memory_bytes,
        collective_bytes=sum(counter.coll_bytes.values()),
        collective_counts=dict(counter.coll_counts),
        collective_bytes_by_type=dict(counter.coll_bytes),
        dot_count=counter.dot_count, uncounted=uncounted,
        devices=sorted(counter.devices),
        peak_live_bytes=(counter.peak_live if counter.track_live
                         else None))
