"""CapStore design space exploration: SMP / SEP / HY on-chip organizations,
with and without power gating, plus the all-on-chip [11] and hierarchy
baselines (paper Secs. 3.2, 4.2, 5; Tables 1/2; Figs. 5, 10, 11).

The counterpart of ``repro/core/dse.py``, the same exploration, scoring
the phases of the port's ``ExecutionPlan`` (``explore(plan=...)``,
``evaluate_plan``).

Sizing rules (paper Sec. 4.2, "Application-Aware Design Space Exploration"):

  * banks          = 16            (matches the 16x16 systolic array)
  * SMP capacity   = worst-case per-operation TOTAL requirement (Fig. 4a)
  * SEP capacities = worst-case per-COMPONENT requirement (Fig. 4c)
  * HY separated   = per-component MINIMUM across operations;
    HY shared      = worst-case total minus the sum of the separated sizes
  * sector count   = chosen by the DSE (the paper picks 64/128); the PG
    granularity must resolve the utilization deltas of Fig. 4a/4c.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

from repro_torch.core import analysis
from repro_torch.core.analysis import COMPONENTS, OperationProfile
from repro_torch.core import energy as E
from repro_torch.core.energy import SRAMConfig
from repro_torch.core.pmu import PhaseRequirement, PMUSchedule, build_schedule

BANKS = 16
ALL_ONCHIP_BYTES = 8 * 1024 * 1024      # CapsAcc [11]: 8 MB fully on-chip


# ---------------------------------------------------------------------------
# Organization definitions
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MemoryOrg:
    """A full on-chip organization: named SRAMs + component->SRAM routing.

    ``routing`` maps each access component ("data"/"weight"/"accum") to a
    list of (sram_name, fraction) pairs; fractions may depend on the op via
    the HY overflow rule, so they are resolved per-op in ``evaluate``.
    """

    name: str
    srams: tuple[SRAMConfig, ...]
    power_gated: bool

    def sram(self, name: str) -> SRAMConfig:
        for s in self.srams:
            if s.name == name:
                return s
        raise KeyError(name)

    @property
    def total_bytes(self) -> float:
        return sum(s.capacity_bytes for s in self.srams)

    @property
    def area_mm2(self) -> float:
        return sum(s.area_mm2() for s in self.srams)


def _mk(name: str, cap: float, ports: int, pg: bool, sectors: int) -> SRAMConfig:
    return SRAMConfig(name=name, capacity_bytes=int(cap), ports=ports,
                      banks=BANKS, sectors_per_bank=sectors if pg else 1,
                      power_gated=pg)


def design_organizations(profiles: Sequence[OperationProfile],
                         sectors: int = 128) -> dict[str, MemoryOrg]:
    """Build the six CapStore organizations of Table 1 (+ derived sizes)."""
    peak_total = analysis.peak_total_mem(profiles)
    comp_max = {c: analysis.peak_component_mem(profiles, c) for c in COMPONENTS}
    comp_min = {c: analysis.min_component_mem(profiles, c) for c in COMPONENTS}
    hy_shared = max(peak_total - sum(comp_min.values()), 0.0)

    orgs: dict[str, MemoryOrg] = {}
    for pg in (False, True):
        tag = "PG-" if pg else ""
        orgs[f"{tag}SMP"] = MemoryOrg(
            name=f"{tag}SMP", power_gated=pg,
            srams=(_mk("shared", peak_total, ports=3, pg=pg, sectors=sectors),),
        )
        orgs[f"{tag}SEP"] = MemoryOrg(
            name=f"{tag}SEP", power_gated=pg,
            srams=tuple(_mk(c, comp_max[c], ports=1, pg=pg, sectors=sectors)
                        for c in COMPONENTS),
        )
        orgs[f"{tag}HY"] = MemoryOrg(
            name=f"{tag}HY", power_gated=pg,
            srams=(_mk("shared", hy_shared, ports=3, pg=pg, sectors=sectors),)
            + tuple(_mk(c, comp_min[c], ports=1, pg=False, sectors=1)
                    for c in COMPONENTS),
        )
    return orgs


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SramEnergy:
    name: str
    dynamic_mj: float
    static_mj: float
    wakeup_mj: float
    area_mm2: float

    @property
    def total_mj(self) -> float:
        return self.dynamic_mj + self.static_mj + self.wakeup_mj


@dataclasses.dataclass(frozen=True)
class OrgEvaluation:
    org: MemoryOrg
    per_sram: tuple[SramEnergy, ...]
    per_op_mj: dict[str, float]
    schedules: tuple[PMUSchedule, ...]

    @property
    def dynamic_mj(self) -> float:
        return sum(s.dynamic_mj for s in self.per_sram)

    @property
    def static_mj(self) -> float:
        return sum(s.static_mj for s in self.per_sram)

    @property
    def wakeup_mj(self) -> float:
        return sum(s.wakeup_mj for s in self.per_sram)

    @property
    def total_mj(self) -> float:
        return self.dynamic_mj + self.static_mj + self.wakeup_mj

    @property
    def area_mm2(self) -> float:
        return self.org.area_mm2

    @property
    def wakeup_latency_cycles(self) -> float:
        return sum(s.wakeup_latency_cycles for s in self.schedules)


def _component_routing(org: MemoryOrg, op: OperationProfile,
                       comp: str) -> list[tuple[str, float]]:
    """Where do `comp` accesses of `op` go?  [(sram_name, fraction), ...]"""
    kind = org.name.removeprefix("PG-")
    if kind == "SMP":
        return [("shared", 1.0)]
    if kind == "SEP":
        return [(comp, 1.0)]
    # HY: the separated memory absorbs up to its capacity; overflow goes to
    # the shared multi-port memory.
    sep_cap = org.sram(comp).capacity_bytes
    req = max(op.component(comp), 1e-9)
    frac_sep = min(sep_cap / req, 1.0)
    return [(comp, frac_sep), ("shared", 1.0 - frac_sep)]


def _phase_requirements(org: MemoryOrg, sram_name: str,
                        profiles: Sequence[OperationProfile],
                        phase_groups: Sequence[tuple[str, Sequence[str]]]
                        | None = None,
                        phase_durations: dict[str, float] | None = None
                        ) -> list[PhaseRequirement]:
    """Per-phase byte demand on one SRAM (drives the PMU schedule).

    ``phase_groups`` -- ``(phase_name, covered profile names)`` pairs from
    an ``ExecutionPlan`` -- merges the dataflow operations a fused kernel
    executes as ONE phase into one gating phase (peak demand over the
    members, summed duration), so the schedule scores what actually runs.
    ``phase_durations`` overrides a phase's duration with the plan's own
    cycle estimate (a STREAMED fused phase re-streams W ``iters + 1``
    times, so its leakage window is longer than the one-pass profile sum
    the members alone imply).  Without groups every profile is its own
    phase (the paper's model).
    """
    kind = org.name.removeprefix("PG-")
    per_op: dict[str, tuple[float, float]] = {}
    for op in profiles:
        if kind == "SMP":
            need = op.total_mem
        elif kind == "SEP":
            need = op.component(sram_name)
        else:  # HY
            if sram_name == "shared":
                need = sum(max(op.component(c) - org.sram(c).capacity_bytes, 0.0)
                           for c in COMPONENTS)
            else:
                need = min(op.component(sram_name),
                           org.sram(sram_name).capacity_bytes)
        per_op[op.name] = (need, op.total_cycles)
    if phase_groups is None:
        phase_groups = tuple((op.name, (op.name,)) for op in profiles)
    reqs = []
    for phase_name, members in phase_groups:
        duration = (phase_durations or {}).get(
            phase_name, sum(per_op[m][1] for m in members))
        reqs.append(PhaseRequirement(
            name=phase_name,
            required_bytes=max(per_op[m][0] for m in members),
            duration_cycles=duration))
    return reqs


def evaluate(org: MemoryOrg, profiles: Sequence[OperationProfile], *,
             phase_groups: Sequence[tuple[str, Sequence[str]]] | None = None,
             phase_durations: dict[str, float] | None = None
             ) -> OrgEvaluation:
    """Score ``org``: dynamic energy from the per-operation access counts,
    static/wakeup from the PMU gating schedule.  ``phase_groups`` (see
    ``_phase_requirements``) gates over fused executed phases instead of
    one phase per dataflow operation; ``phase_durations`` carries the
    plan's per-phase cycle estimates (pass-count-aware for streamed
    fused schedules)."""
    names = [op.name for op in profiles]
    if len(set(names)) != len(names):
        # Accesses and phase demands are keyed by profile name; a repeated
        # routing layer must carry its per-instance suffix ("...[k]") or
        # its instances would silently collapse into one phase here.
        dupes = sorted({n for n in names if names.count(n) > 1})
        raise ValueError(f"duplicate operation profile names {dupes}: "
                         f"repeated layers need per-instance suffixes")
    dyn = {s.name: 0.0 for s in org.srams}
    per_op = {op.name: 0.0 for op in profiles}

    # Dynamic energy: route each component's accesses to its SRAM(s).
    for op in profiles:
        for comp in COMPONENTS:
            reads = {"data": op.data_reads, "weight": op.weight_reads,
                     "accum": op.accum_reads}[comp] * op.repeats
            writes = {"data": op.data_writes, "weight": op.weight_writes,
                      "accum": op.accum_writes}[comp] * op.repeats
            for sram_name, frac in _component_routing(org, op, comp):
                if frac <= 0.0:
                    continue
                s = org.sram(sram_name)
                e_pj = (reads * s.access_energy_pj(write=False)
                        + writes * s.access_energy_pj(write=True)) * frac
                dyn[sram_name] += e_pj * 1e-9
                per_op[op.name] += e_pj * 1e-9

    # Static + wakeup energy via the PMU schedule per SRAM.
    schedules = []
    per_sram = []
    for s in org.srams:
        sched = build_schedule(s, _phase_requirements(org, s.name, profiles,
                                                      phase_groups,
                                                      phase_durations))
        schedules.append(sched)
        per_sram.append(SramEnergy(
            name=s.name, dynamic_mj=dyn[s.name],
            static_mj=sched.static_mj, wakeup_mj=sched.wakeup_mj,
            area_mm2=s.area_mm2()))
        for ph in sched.phases:
            # fused phases carry the plan-op name, not a profile name
            per_op[ph.name] = (per_op.get(ph.name, 0.0)
                               + ph.leakage_mj + ph.wakeup_mj)

    return OrgEvaluation(org=org, per_sram=tuple(per_sram),
                         per_op_mj=per_op, schedules=tuple(schedules))


# ---------------------------------------------------------------------------
# Baselines (Fig. 5) and complete-accelerator accounting (Fig. 11)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SystemEnergy:
    """Complete-architecture energy breakdown (mJ)."""

    name: str
    accelerator_mj: float
    buffers_mj: float
    onchip_mj: float
    offchip_mj: float
    onchip_area_mm2: float

    @property
    def total_mj(self) -> float:
        return (self.accelerator_mj + self.buffers_mj + self.onchip_mj
                + self.offchip_mj)

    @property
    def memory_fraction(self) -> float:
        return (self.onchip_mj + self.offchip_mj) / self.total_mj

    @property
    def total_area_mm2(self) -> float:
        return self.onchip_area_mm2 + E.ACCEL_AREA_MM2 + E.BUFFER_AREA_MM2


def _common_terms(profiles: Sequence[OperationProfile]) -> tuple[float, float, float]:
    dur = E.cycles_to_s(analysis.total_cycles(profiles))
    macs = analysis.total_macs(profiles)
    accel = E.accelerator_dynamic_mj(macs) + E.accelerator_static_mj(dur)
    onchip_accesses = sum(
        (op.data_reads + op.data_writes + op.weight_reads + op.weight_writes
         + op.accum_reads + op.accum_writes) * op.repeats for op in profiles)
    buffers = E.buffer_energy_mj(onchip_accesses)
    return dur, accel, buffers


def all_onchip_system(profiles: Sequence[OperationProfile]) -> SystemEnergy:
    """Version (a): CapsAcc [11] with everything in one 8 MB on-chip SRAM."""
    dur, accel, buffers = _common_terms(profiles)
    # [11] uses one monolithic on-chip memory; the dedicated buffers of
    # Fig. 3 provide the multi-access paths, so the big SRAM is single-port.
    sram = SRAMConfig(name="all-onchip", capacity_bytes=ALL_ONCHIP_BYTES,
                      ports=1, banks=8)
    accesses = 0.0
    for op in profiles:
        accesses += (op.data_reads + op.data_writes + op.weight_reads
                     + op.weight_writes + op.accum_reads + op.accum_writes
                     ) * op.repeats
        # weights/fmaps that the hierarchy would spill now also hit the big
        # SRAM (they are the same values, kept resident).
        accesses += (op.offchip_reads + op.offchip_writes) * op.repeats
    onchip = (accesses * sram.access_energy_pj() * 1e-9
              + sram.leakage_mw() * dur)  # mW * s = mJ
    return SystemEnergy(name="all-onchip[11]", accelerator_mj=accel,
                        buffers_mj=buffers, onchip_mj=onchip, offchip_mj=0.0,
                        onchip_area_mm2=sram.area_mm2())


def hierarchy_system(profiles: Sequence[OperationProfile],
                     ev: OrgEvaluation) -> SystemEnergy:
    """Version (b)+: on-chip org `ev` + off-chip DRAM per Eqs. (1)/(2)."""
    dur, accel, buffers = _common_terms(profiles)
    off_accesses = analysis.total_offchip_accesses(profiles)
    off = E.dram_energy_pj(off_accesses) * 1e-9 + E.dram_static_mj(dur)
    return SystemEnergy(name=f"hierarchy/{ev.org.name}", accelerator_mj=accel,
                        buffers_mj=buffers, onchip_mj=ev.total_mj,
                        offchip_mj=off, onchip_area_mm2=ev.area_mm2)


# ---------------------------------------------------------------------------
# Full DSE (paper Sec. 4.2): sweep organizations x sector counts
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DSEResult:
    org_name: str
    sectors: int
    total_mj: float
    area_mm2: float
    evaluation: OrgEvaluation


def explore(profiles: Sequence[OperationProfile] | None = None,
            sector_choices: Sequence[int] = (1, 2, 4, 8, 16, 32, 64, 128, 256),
            *, plan=None, train: bool = False) -> list[DSEResult]:
    """Evaluate every organization x sector count; sorted by energy.

    The profiles default to those of an ``ExecutionPlan`` compiled for the
    paper's CapsuleNet -- i.e. the PMU/energy schedule scored here is the
    SAME schedule the port's kernels execute, gated over the plan's FUSED
    phases (``plan.phase_groups()``: the votes+routing megakernel is one
    phase).  Pass ``plan=`` to score a differently-shaped network, or raw
    ``profiles`` for paper-model ablations (one phase per operation).

    ``train=True`` compiles the default plan with its backward OpPlans,
    so the organizations are sized for (and the PMU gates) a full
    training step: forward phases then backward phases in reverse
    network order, one per executed backward kernel.
    """
    phase_groups = None
    phase_durations = None
    if profiles is None:
        if plan is None:
            from repro_torch.core import execplan
            from repro_torch.core.capsnet import CapsNetConfig
            plan = execplan.compile_plan(CapsNetConfig(), train=train)
        profiles = plan.profiles
        phase_groups = plan.phase_groups()
        phase_durations = plan.phase_durations()
    elif plan is not None:
        raise ValueError("pass either profiles or plan, not both")
    profiles = list(profiles)
    results = []
    seen = set()
    for sectors, pg in itertools.product(sector_choices, (False, True)):
        if not pg and sectors != 1:
            continue  # sectors only matter with power gating
        orgs = design_organizations(profiles, sectors=sectors)
        for name, org in orgs.items():
            if org.power_gated != pg:
                continue
            key = (name, sectors if pg else 1)
            if key in seen:
                continue
            seen.add(key)
            ev = evaluate(org, profiles, phase_groups=phase_groups,
                          phase_durations=phase_durations)
            results.append(DSEResult(org_name=name, sectors=sectors if pg else 1,
                                     total_mj=ev.total_mj, area_mm2=ev.area_mm2,
                                     evaluation=ev))
    results.sort(key=lambda r: r.total_mj)
    return results


def best_design(profiles: Sequence[OperationProfile] | None = None,
                *, plan=None, train: bool = False) -> DSEResult:
    return explore(profiles, plan=plan, train=train)[0]


def evaluate_plan(org: MemoryOrg, plan) -> OrgEvaluation:
    """Score ``org`` against the schedule of an ``ExecutionPlan``: the
    dataflow access counts with the gating schedule built over the plan's
    fused executed phases (``plan.phase_groups()``) and the plan's
    pass-count-aware phase durations."""
    return evaluate(org, plan.profiles, phase_groups=plan.phase_groups(),
                    phase_durations=plan.phase_durations())
