"""Plan auditor: hold each OpPlan to the built Hopper kernels and the card.

The counterpart of ``repro/verify/lowering.py``, whose name it keeps so
that a reader finds it.  The port has no lowering to trace: this module
audits the built kernels and their launches.  ``core.execplan`` models
each ``OpPlan``'s shared memory a CTA (``smem_bytes``), its global-memory
traffic (``global_bytes``), its votes passes (``n_passes``), and, by its
kernel, the reference's zero-intermediate claims (u_hat, and in the
pipelined op u, never reach device memory).  ``degrade_plan``, the PMU
schedule, the DSE and the energy model all read those numbers, so a
kernel edit that silently drifts from them corrupts every decision built
on them.  The truth held against them comes from the card and the built
kernels, never from the Python model that produced the plan.

Two halves:

* ``derive_op(plan, op)`` runs only on the card.  It runs the op's kernel
  call once at the plan's shapes, on inputs drawn from a seed, and
  gathers ``OpFacts``:

  - every launch of a ``build.Kernel`` (``build.record_launches``), and
    for each kernel a launch ran, ``cudaFuncGetAttributes``'s static
    shared memory plus the dynamic shared memory that launch opts into,
    and how many of its clusters (or, for a plain kernel, CTAs an SM) the
    card holds at once -- from each library's ``*_occupancy`` and
    ``*_attributes`` entries, whose layouts are the kernels' own C code;
  - the votes computations a sample makes, from each routing library's
    ``*_passes`` host entry, which counts them with the function the
    kernel's pass loop runs on (``route_passes`` in
    ``csrc/routing_cluster.cuh``), and a CTA's blocks of votes rows;
  - the bytes the op's kernels request from L2, read and written
    (``lts__t_sectors_srcunit_tex_op_{read,write}.sum``), through CUPTI's
    range profiler (``torch.profiler``'s experimental metrics), or the
    reason the counters could not be read;
  - the shape of every tensor that owns its storage and that the run
    allocated (a ``TorchDispatchMode``; views do not count).  No C entry
    allocates device memory (none calls ``cudaMalloc``): every buffer a
    kernel writes is a torch allocation, which the mode sees, so a u_hat
    that reached device memory shows here.  Keep it so.

* ``compare(plan, op, facts)`` is pure: it turns the facts and the
  ``OpPlan`` into ``Check``s, within the op's ``execplan.audit_contract``.
  The CPU tests drive it with seeded facts.

A check that cannot be measured (the counters, where the card does not
let a process read them) is ``unverified``: never ok, never a silent
skip, and counted apart from drift.  ``python -m repro_torch.verify``
sweeps the archs, plans and budgets.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import tempfile

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.core import execplan
from repro_torch.core.capsnet import CapsNetConfig
from repro_torch.core.execplan import BWD_SUFFIX, ExecutionPlan, OpPlan
from repro_torch.device import resolve_device
from repro_torch.kernels import build

# The card's L2 counters of the bytes the SMs ask of it, in 32-byte sectors.
L2_METRICS = ("lts__t_sectors_srcunit_tex_op_read.sum",
              "lts__t_sectors_srcunit_tex_op_write.sum")
SECTOR_BYTES = 32
UHAT_CLAIM = "uhat-never-in-device-memory"
U_CLAIM = "u-never-in-device-memory"


class AuditError(RuntimeError):
    """An op could not be run, or its launches matched to its plan entry."""


# ---------------------------------------------------------------------------
# Facts and checks
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class KernelFacts:
    """One kernel a launch ran, as the card reports it."""

    entry: str               # the C entry that launched it
    kernel: str              # which of the entry's kernels
    static_smem: int         # cudaFuncGetAttributes' sharedSizeBytes
    dynamic_smem: int        # the dynamic shared memory the launch opts into
    resident: int            # clusters (cluster kernels) or CTAs an SM at once
    cluster: int | None = None   # CTAs a cluster, for a cluster kernel

    @property
    def smem_bytes(self) -> int:
        return self.static_smem + self.dynamic_smem


@dataclasses.dataclass(frozen=True)
class OpFacts:
    """What the card and the built kernels say of one op's run."""

    kernels: tuple[KernelFacts, ...]
    passes: int | None = None        # votes computations a sample
    w_blocks: int | None = None      # a CTA's blocks of votes rows
    global_bytes: float | None = None    # requested from L2, read + written
    counter_note: str = ""           # why global_bytes is None
    shapes: tuple[tuple[int, ...], ...] = ()   # the run's own allocations


@dataclasses.dataclass(frozen=True)
class Check:
    name: str
    ok: bool
    detail: str
    unverified: bool = False     # not measured: never ok, counted apart

    @property
    def drift(self) -> bool:
        return not self.ok and not self.unverified


@dataclasses.dataclass(frozen=True)
class OpAudit:
    op: str
    kernel: str
    facts: OpFacts
    checks: tuple[Check, ...]
    plan_op: OpPlan | None = None    # the plan entry the facts were held to

    @property
    def ok(self) -> bool:
        """No drift (an unverified check is no drift, and is never ok)."""
        return not self.failures()

    def failures(self) -> list[Check]:
        return [c for c in self.checks if c.drift]

    def unverified(self) -> list[Check]:
        return [c for c in self.checks if c.unverified]


@dataclasses.dataclass(frozen=True)
class PlanAudit:
    label: str
    ops: tuple[OpAudit, ...]

    @property
    def ok(self) -> bool:
        return all(o.ok for o in self.ops)

    def failures(self) -> list[tuple[str, Check]]:
        return [(o.op, c) for o in self.ops for c in o.failures()]

    def unverified(self) -> list[tuple[str, Check]]:
        return [(o.op, c) for o in self.ops for c in o.unverified()]


# ---------------------------------------------------------------------------
# The zero-intermediate claims
# ---------------------------------------------------------------------------

def _layer_for(plan: ExecutionPlan, op_name: str):
    base = (op_name[:-len(BWD_SUFFIX)] if op_name.endswith(BWD_SUFFIX)
            else op_name)
    for lay in plan.cfg.routing_stack():
        if lay.name == base:
            return lay
    raise AuditError(f"{op_name}: no routing layer matches this op")


def _i_pad(i_dim: int, block_i: int) -> int:
    return math.ceil(i_dim / max(block_i, 1)) * max(block_i, 1)


def zero_intermediate_claims(plan: ExecutionPlan, op: OpPlan
                             ) -> dict[str, tuple[set, set]]:
    """The claims the reference's plan makes for ``op`` (its
    ``uhat_hbm_bytes == 0`` and ``intermediate_hbm_bytes == 0``), each as
    (forbidden shapes, allowed shapes): u_hat never in device memory on
    every fused routing op, forward and backward, and on the pipelined
    op; u too on the pipelined op where it feeds the last layer."""
    if op.kernel not in ("votes_routing", "votes_routing_bwd",
                         "primary_routing"):
        return {}
    b = plan.batch
    lay = (plan.cfg.routing_stack()[0] if op.kernel == "primary_routing"
           else _layer_for(plan, op.name))
    pad = _i_pad(lay.in_caps, op.block_i or lay.in_caps)
    j, d = lay.num_caps, lay.caps_dim
    # u_hat as [B, I, J*D] or [B, I, J, D], i-padded or not, or with the
    # batch inside (a batched product's [I, B, J*D]).
    uhat = {s for i in (lay.in_caps, pad)
            for s in ((b, i, lay.jd), (b, i, j, d), (i, b, lay.jd))}
    u = {(b, i, lay.in_dim) for i in (lay.in_caps, pad)}
    if op.kernel != "primary_routing":
        return {UHAT_CLAIM: (uhat, u)}
    claims = {UHAT_CLAIM: (uhat, set())}
    if len(plan.cfg.routing_stack()) == 1:
        claims[U_CLAIM] = (u, set())
    return claims


def _shape_check(shapes, forbidden: set, allowed: set, claim: str) -> Check:
    hits = sorted({tuple(s) for s in shapes
                   if tuple(s) in forbidden and tuple(s) not in allowed})
    return Check(
        name=claim, ok=not hits,
        detail=("no tensor of a forbidden shape in device memory" if not hits
                else f"tensor(s) of forbidden shape {hits} reached device "
                     f"memory, against the zero-intermediate claim"))


def claim_checks(plan: ExecutionPlan, op: OpPlan, shapes) -> list[Check]:
    """The zero-intermediate checks of ``op`` over the shapes of the
    tensors a run allocated (``record_allocations``)."""
    return [_shape_check(shapes, forbidden, allowed, claim)
            for claim, (forbidden, allowed)
            in zero_intermediate_claims(plan, op).items()]


class _Allocations(TorchDispatchMode):
    """Records the shape of every op output that owns its storage: an
    output whose schema declares no alias (a view or an in-place result
    aliases an input)."""

    def __init__(self):
        super().__init__()
        self.shapes: list[tuple[int, ...]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        returns = func._schema.returns
        outs = out if len(returns) > 1 else (out,)
        for ret, value in zip(returns, outs):
            if ret.alias_info is None:
                self.shapes += [tuple(t.shape) for t in tree_leaves(value)
                                if isinstance(t, torch.Tensor)]
        return out


@contextlib.contextmanager
def record_allocations():
    """The shapes of the tensors allocated inside the block, in order
    (on any device: the CPU tests hold plain functions to the claims)."""
    mode = _Allocations()
    with mode:
        yield mode.shapes


# ---------------------------------------------------------------------------
# The comparison (pure)
# ---------------------------------------------------------------------------

_BWD_PASSES_NOTE = ("; the port's backward counts votes computations, 1 "
                    "resident and iters + 2 streamed, where the reference "
                    "counts W streams, 2 and iters + 4")


def compare(plan: ExecutionPlan, op: OpPlan, facts: OpFacts) -> list[Check]:
    """``op``'s checks against what its run showed (see the module
    note), within ``execplan.audit_contract(op)``."""
    contract = execplan.audit_contract(op)
    if not facts.kernels:
        raise AuditError(f"{op.name}: its run launched no kernel")
    checks: list[Check] = []
    derived = max(k.smem_bytes for k in facts.kernels)
    peak = max(facts.kernels, key=lambda k: k.smem_bytes)
    limit = op.smem_bytes * (1 + contract.smem_rtol)
    checks.append(Check(
        name="smem-under-model", ok=derived <= limit,
        detail=(f"derived {derived} B a CTA ({peak.kernel}: "
                f"{peak.static_smem} static + {peak.dynamic_smem} dynamic) "
                f"vs modeled {op.smem_bytes} B (+{contract.smem_rtol:.0%} "
                f"tolerance)")))
    checks.append(Check(
        name="smem-over-model",
        ok=op.smem_bytes <= derived * contract.smem_over_factor,
        detail=(f"modeled {op.smem_bytes} B vs derived {derived} B "
                f"(x{contract.smem_over_factor:g} slack)")))

    busy = min(facts.kernels, key=lambda k: k.resident)
    wrong_cluster = sorted({k.cluster for k in facts.kernels
                            if k.cluster is not None
                            and k.cluster != op.cluster})
    fits = (derived <= plan.smem_budget and busy.resident >= 1
            and not wrong_cluster)
    checks.append(Check(
        name="fits-the-card", ok=fits,
        detail=(f"{derived} B a CTA within the {plan.smem_budget} B budget; "
                f"the card holds {busy.resident} of {busy.kernel} at once"
                + (f" (clusters of {busy.cluster})" if busy.cluster else "")
                + (f"; launched on clusters of {wrong_cluster}, planned "
                   f"{op.cluster}" if wrong_cluster else ""))))

    if op.n_passes is not None:
        if facts.passes is None:
            checks.append(Check(
                name="w-pass-count", ok=False,
                detail=f"no routing kernel among "
                       f"{[k.kernel for k in facts.kernels]}"))
        else:
            # A streamed CTA whose rows are one block brings the same W
            # rows in every pass: they cross device memory once.
            single = facts.passes > 1 and facts.w_blocks == 1
            got = 1 if single else facts.passes
            want = 1 if single else op.n_passes
            checks.append(Check(
                name="w-pass-count", ok=got == want,
                detail=(f"the kernel computes the votes {got} time(s) a "
                        f"sample, the plan models {want} ({op.mode}"
                        f"{', single i-block' if single else ''})"
                        + (_BWD_PASSES_NOTE if op.name.endswith(BWD_SUFFIX)
                           else ""))))

    if facts.global_bytes is None:
        checks.append(Check(
            name="global-traffic", ok=False, unverified=True,
            detail=f"not measured: {facts.counter_note}"))
    else:
        rel = (abs(facts.global_bytes - op.global_bytes)
               / max(op.global_bytes, 1.0))
        checks.append(Check(
            name="global-traffic", ok=rel <= contract.global_rtol,
            detail=(f"requested from L2 {facts.global_bytes:.0f} B vs "
                    f"modeled {op.global_bytes:.0f} B ({rel:.1%} off, "
                    f"tolerance {contract.global_rtol:.0%})")))

    checks += claim_checks(plan, op, facts.shapes)
    return checks


# ---------------------------------------------------------------------------
# The facts, on the card
# ---------------------------------------------------------------------------

def _rand(gen, dev, *shape, scale=1.0, grad=False) -> torch.Tensor:
    t = torch.randn(shape, generator=gen, device=dev) * scale
    return t.requires_grad_() if grad else t


def _conv_geometry(cfg: CapsNetConfig, name: str):
    """(input hw, input channels, kernel, output channels, stride) of the
    conv op ``name``."""
    if name == "Conv1":
        return (cfg.image_hw, cfg.in_channels, cfg.conv1_kernel,
                cfg.conv1_channels, 1)
    return (cfg.conv1_out, cfg.conv1_channels, cfg.pc_kernel,
            cfg.pc_channels, cfg.pc_stride)


def _runner(plan: ExecutionPlan, op: OpPlan, dev, gen):
    """A function that runs ``op``'s kernel call once at the plan's shapes,
    as the network runs it; its inputs are drawn here, before it runs."""
    from repro_torch.kernels.conv_im2col import conv2d_im2col
    from repro_torch.kernels.primary_routing import primary_routing
    from repro_torch.kernels.votes_routing import (votes_routing,
                                                   votes_routing_bwd)
    cfg, b = plan.cfg, plan.batch
    if op.kernel in ("conv_im2col", "conv_im2col+squash", "conv_im2col_bwd"):
        name = op.name.removesuffix(BWD_SUFFIX)
        hw, cin, k, cout, stride = _conv_geometry(cfg, name)
        bwd = op.kernel == "conv_im2col_bwd"
        if name == "Conv1":
            epilogue = "relu"
        elif bwd:              # the backward recomputes a fused squash's input
            epilogue = ("squash" if plan.pipelined
                        or plan.op("PrimaryCaps").fuses_squash else "none")
        else:
            epilogue = "squash" if op.fuses_squash else "none"
        if name == "PrimaryCaps" and epilogue == "none":
            raise AuditError(f"{op.name}: the standalone squash (K10) has no "
                             f"audit entry; every plan of the sweep fuses it")
        x = _rand(gen, dev, b, hw, hw, cin,
                  grad=bwd and name != "Conv1")       # the image needs none
        w = _rand(gen, dev, k, k, cin, cout, scale=(k * k * cin) ** -0.5,
                  grad=bwd)
        bias = _rand(gen, dev, cout, scale=0.1, grad=bwd)
        kw = dict(stride=stride, block=op.block.tiles, epilogue=epilogue,
                  squash_dim=cfg.primary_dim if epilogue == "squash" else 0,
                  dx_block=(op.dx_block or op.block).tiles)
        if not bwd:
            def run():
                with torch.no_grad():
                    conv2d_im2col(x, w, bias, **kw)
            return run
        with torch.enable_grad():
            y = conv2d_im2col(x, w, bias, **kw)
        g = _rand(gen, dev, *y.shape)
        inputs = (w, bias) if name == "Conv1" else (x, w, bias)

        def run():
            torch.autograd.grad(y, inputs, g, retain_graph=True)
        return run
    if op.kernel == "primary_routing":
        lay = cfg.routing_stack()[0]
        hw, cin, k, cout, _ = _conv_geometry(cfg, "PrimaryCaps")
        x = _rand(gen, dev, b, hw, hw, cin).abs_()
        w_pc = _rand(gen, dev, k, k, cin, cout, scale=(k * k * cin) ** -0.5)
        b_pc = _rand(gen, dev, cout, scale=0.1)
        w_cc = _rand(gen, dev, lay.in_caps, lay.jd, lay.in_dim, scale=0.05)

        def run():
            with torch.no_grad():
                primary_routing(x, w_pc, b_pc, w_cc, stride=cfg.pc_stride,
                                iters=lay.iters, num_classes=lay.num_caps,
                                mode=op.mode, block_i=op.block_i,
                                cluster=op.cluster)
        return run
    if op.kernel in ("votes_routing", "votes_routing_bwd"):
        lay = _layer_for(plan, op.name)
        u = _rand(gen, dev, b, lay.in_caps, lay.in_dim, scale=0.1)
        w = _rand(gen, dev, lay.in_caps, lay.jd, lay.in_dim, scale=0.05)
        kw = dict(iters=lay.iters, num_classes=lay.num_caps, mode=op.mode,
                  block_i=op.block_i, cluster=op.cluster)
        if op.kernel == "votes_routing_bwd":
            g = _rand(gen, dev, b, lay.jd)

            def run():
                votes_routing_bwd(u, w, g, smem_budget=plan.smem_budget,
                                  **kw)
            return run
        r = _rand(gen, dev, b, lay.jd, scale=0.1) if lay.residual else None

        def run():
            with torch.no_grad():
                votes_routing(u, w, r=r, **kw)
        return run
    raise AuditError(f"{op.name}: no audit runner for kernel {op.kernel!r} "
                     f"-- teach verify.lowering about it")


# The arguments of each C entry, in order (kernels/*.py passes them so).
_ARGS = {
    "im2col_patches_f32": "x out B H W C KH KW stride stream",
    "matmul_bias_act_f32": ("A Bw bias out part M N K block_m tile_bn tile_n "
                            "block_k split_k slab epilogue squash_dim stream"),
    "matmul_at_b_f32": "A B out part M K N splits rows wide_rows stream",
    "col2im_patches_f32": "dp dx B H W C KH KW stride stream",
    "votes_routing_cluster_f32": "u W r out B I C J D iters cs smem stream",
    "votes_routing_streamed_cluster_f32": ("u W r out B I C J D iters "
                                           "block_i cs smem stream"),
    "votes_routing_global_cluster_f32": ("u W r logits out B I C J D iters "
                                         "block_i cs smem stream"),
    "primary_routing_f32": ("patches wpc bias W out B P K N C J D iters "
                            "resident block_i cs smem stream"),
    "routing_bwd_cluster_f32": ("u W g b_prev b_last ds du_part du dW B I C "
                                "J D iters resident block_i cs smem "
                                "emit_cols emit_smem stream"),
    "routing_bwd_global_cluster_f32": ("u W g b_prev b_last ds du_part du dW "
                                       "B I C J D iters block_i cs smem "
                                       "emit_cols emit_smem stream"),
}


def _aligned(*ptrs) -> bool:
    return all(p is not None and p.value is not None and p.value % 16 == 0
               for p in ptrs)


def _plain(entry: str, kernel: str, q) -> KernelFacts:
    return KernelFacts(entry, kernel, q[1], q[2], q[0])


def _clustered(entry: str, kernel: str, q, cs: int) -> KernelFacts:
    return KernelFacts(entry, kernel, q[1], q[2], q[0], cs)


def _launch_facts(entry: str, args) -> tuple[list[KernelFacts],
                                             tuple[int, int] | None]:
    """The kernels one launch of ``entry`` ran, with what the card says of
    each, and (votes computations a sample, a CTA's blocks of rows) for a
    routing launch."""
    if entry not in _ARGS:
        raise AuditError(f"no audit entry for the launch of {entry!r} -- "
                         f"teach verify.lowering about it")
    a = dict(zip(_ARGS[entry].split(), args))
    q = build.query
    if entry == "im2col_patches_f32":
        vec = a["C"] % 4 == 0 and _aligned(a["x"], a["out"])
        return [_plain(entry, f"im2col_kernel<{'float4' if vec else 'float'}>",
                       q("conv_im2col", "im2col_attributes", int(vec)))], None
    if entry == "matmul_bias_act_f32":
        return [_plain(entry, f"gemm_kernel {a['block_m']}x{a['tile_bn']}"
                              f"x{a['block_k']} split {a['split_k']}",
                       q("conv_im2col", "matmul_bias_act_occupancy",
                         a["block_m"], a["tile_bn"], a["block_k"],
                         a["epilogue"], a["split_k"]))], None
    if entry == "matmul_at_b_f32":
        out = []
        if a["wide_rows"] > 0:
            out.append(_plain(entry, f"at_b 128x128 split {a['splits']}",
                              q("conv_bwd", "matmul_at_b_occupancy", 1,
                                a["splits"])))
        if a["wide_rows"] < a["K"]:
            out.append(_plain(entry, "at_b 128x64",
                              q("conv_bwd", "matmul_at_b_occupancy", 0, 1)))
        return out, None
    if entry == "col2im_patches_f32":
        vec = a["C"] % 4 == 0 and _aligned(a["dp"], a["dx"])
        return [_plain(entry, f"col2im_kernel<{a['stride']}, "
                              f"{'float4' if vec else 'float'}>",
                       q("conv_bwd", "col2im_attributes", a["stride"],
                         int(vec)))], None
    if entry.startswith("votes_routing_"):
        resident = int(entry == "votes_routing_cluster_f32")
        block_i = 1 if resident else a["block_i"]
        glob = int(entry == "votes_routing_global_cluster_f32")
        sizes = (a["I"], a["C"], a["J"], a["D"], a["cs"])
        occupancy = q("votes_routing", "votes_routing_cluster_occupancy",
                      *sizes, resident, block_i, glob)
        facts = _clustered(entry, ("K3" if resident else
                                   "K4g" if glob else "K4"), occupancy,
                           a["cs"])
        return [facts], q("votes_routing", "votes_routing_passes", *sizes,
                          resident, block_i, 0, a["iters"], n_out=2)
    if entry == "primary_routing_f32":
        sizes = (a["P"], a["N"], a["C"], a["J"], a["D"], a["cs"],
                 a["resident"], a["block_i"])
        return ([_clustered(entry, "K5", q("primary_routing",
                                           "primary_routing_occupancy",
                                           *sizes), a["cs"])],
                q("primary_routing", "primary_routing_passes", *sizes,
                  a["iters"], n_out=2))
    glob = entry == "routing_bwd_global_cluster_f32"
    resident = 0 if glob else a["resident"]
    sizes = (a["I"], a["C"], a["J"], a["D"], a["cs"])
    replay = (q("votes_routing_bwd", "routing_bwd_global_occupancy", *sizes,
                a["block_i"]) if glob else
              q("votes_routing_bwd", "routing_bwd_cluster_occupancy", *sizes,
                resident, a["block_i"]))
    split = a["emit_cols"] < a["J"] * a["D"]
    emit = q("votes_routing_bwd", "routing_bwd_emit_occupancy", a["C"],
             a["J"], a["D"], a["emit_cols"])
    return ([_clustered(entry, ("K9g" if glob else "K8" if resident
                                else "K9") + " replay", replay, a["cs"]),
             _plain(entry, "split emit" if split else "emit", emit)],
            q("votes_routing_bwd", "routing_bwd_passes", *sizes, resident,
              a["block_i"], 0, a["iters"], n_out=2))


def l2_bytes(run) -> tuple[float | None, str]:
    """(bytes ``run``'s kernels request from L2, read and written, "") from
    the card's counters (``L2_METRICS``) through CUPTI's range profiler,
    or (None, the reason) where they cannot be read."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as tmp:
        trace_path = os.path.join(tmp, "trace.json")
        try:
            cfg = _ExperimentalConfig(profiler_metrics=list(L2_METRICS),
                                      profiler_measure_per_kernel=True)
            with profile(activities=[ProfilerActivity.CUDA],
                         experimental_config=cfg) as prof:
                run()
                torch.cuda.synchronize()
            prof.export_chrome_trace(trace_path)
            with open(trace_path, encoding="utf-8") as fh:
                events = json.load(fh).get("traceEvents", [])
            error = ""
        except (RuntimeError, ValueError, OSError) as err:
            events, error = [], f"; {type(err).__name__}: {err}"
    sectors = [float((ev.get("args") or {})[m]) for ev in events
               for m in L2_METRICS if m in (ev.get("args") or {})]
    if sectors:
        return SECTOR_BYTES * sum(sectors), ""
    return None, ("CUPTI's range profiler (torch.profiler's experimental "
                  "metrics) gave no lts__t_sectors_srcunit_tex_op_"
                  "{read,write}.sum value: the trace holds activity records "
                  "only" + error)


def derive_op(plan: ExecutionPlan, op: OpPlan, *,
              counters: bool = True) -> OpFacts:
    """Run ``op`` once on the card at the plan's shapes, on inputs drawn
    from a fixed seed, and gather its facts (see the module note).
    ``counters=False`` reads no L2 counter, so the traffic check is
    unverified: a process that also records ``torch.profiler`` traces
    (the ``gpu`` tests) keeps CUPTI's range profiler out.  Without a card
    it raises ``device.resolve_device``'s error."""
    dev = resolve_device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    run = _runner(plan, op, dev, gen)
    torch.cuda.synchronize(dev)
    with build.record_launches() as launches, record_allocations() as shapes:
        run()
    torch.cuda.synchronize(dev)
    kernels: list[KernelFacts] = []
    passes = []
    for entry, args in launches:
        ks, p = _launch_facts(entry, args)
        kernels += ks
        if p is not None:
            passes.append(p)
    if len(set(passes)) > 1:
        raise AuditError(f"{op.name}: its routing launches count their votes "
                         f"passes differently: {passes}")
    if counters:
        nbytes, note = l2_bytes(run)
    else:
        nbytes, note = None, "counters not read (counters=False)"
    return OpFacts(kernels=tuple(kernels),
                   passes=passes[0][0] if passes else None,
                   w_blocks=passes[0][1] if passes else None,
                   global_bytes=nbytes, counter_note=note,
                   shapes=tuple(shapes))


def _facts_key(plan: ExecutionPlan, op: OpPlan):
    """What an op's run depends on beside the op: its config and batch,
    the budget its backward's emit splits under, and whether a conv
    backward recomputes a pipelined squash."""
    return (plan.cfg, plan.batch, op,
            plan.smem_budget if op.kernel == "votes_routing_bwd" else None,
            plan.pipelined if op.kernel == "conv_im2col_bwd" else None)


def audit_op(plan: ExecutionPlan, op: OpPlan, *,
             facts: OpFacts | None = None, counters: bool = True,
             cache: dict | None = None) -> OpAudit:
    """Derive ``op``'s facts on the card (unless given; ``cache`` keeps
    them across plans of a sweep) and compare them with its plan entry."""
    if facts is None:
        key = _facts_key(plan, op)
        if cache is not None and key in cache:
            facts = cache[key]
        else:
            facts = derive_op(plan, op, counters=counters)
            if cache is not None:
                cache[key] = facts
    return OpAudit(op=op.name, kernel=op.kernel, facts=facts,
                   checks=tuple(compare(plan, op, facts)), plan_op=op)


def audit_plan(plan: ExecutionPlan, label: str = "", *,
               counters: bool = True, cache: dict | None = None) -> PlanAudit:
    """Audit every op of a compiled plan on the card."""
    return PlanAudit(
        label=label or f"batch={plan.batch} train={plan.train}",
        ops=tuple(audit_op(plan, op, counters=counters, cache=cache)
                  for op in plan.ops))


def audit_config(cfg: CapsNetConfig, *, batch: int = 1,
                 smem_budget: int | None = None, train: bool = False,
                 pipeline: bool = False, label: str = "",
                 counters: bool = True) -> PlanAudit:
    """Compile ``cfg`` and audit the resulting plan."""
    kw = dict(batch=batch, train=train, pipeline=pipeline)
    if smem_budget is not None:
        kw["smem_budget"] = smem_budget
    return audit_plan(execplan.compile_plan(cfg, **kw), label=label,
                      counters=counters)


def margins(audits) -> dict[str, dict[str, float]]:
    """The worst margins of a sweep's audits by kernel string, the numbers
    ``execplan._AUDIT_CONTRACTS`` is calibrated to: how far the derived
    shared memory exceeds the model (``smem_rtol``), how far the model
    exceeds it (``smem_over_factor``), and the traffic's relative miss
    (``global_rtol``, where the counters were read)."""
    out: dict[str, dict[str, float]] = {}
    for audit in audits:
        op_plan = audit.plan_op
        derived = max(k.smem_bytes for k in audit.facts.kernels)
        row = out.setdefault(audit.kernel, dict(smem_rtol=0.0,
                                                smem_over_factor=1.0,
                                                global_rtol=0.0))
        row["smem_rtol"] = max(row["smem_rtol"],
                               derived / op_plan.smem_bytes - 1.0)
        row["smem_over_factor"] = max(row["smem_over_factor"],
                                      op_plan.smem_bytes / derived)
        if audit.facts.global_bytes is not None:
            row["global_rtol"] = max(
                row["global_rtol"],
                abs(audit.facts.global_bytes - op_plan.global_bytes)
                / max(op_plan.global_bytes, 1.0))
    return out


__all__ = ["AuditError", "Check", "KernelFacts", "OpAudit", "OpFacts",
           "PlanAudit", "audit_config", "audit_op",
           "audit_plan", "claim_checks", "compare", "derive_op", "l2_bytes",
           "margins", "record_allocations", "zero_intermediate_claims"]
