"""Application-aware power management unit (PMU) model.

The counterpart of ``repro/core/pmu.py``, the same model, driven by the
port's ``ExecutionPlan``.

Implements the paper's Sec. 4.3: the PMU knows the CapsuleNet inference
schedule (which operation runs when, and how much of each on-chip memory it
needs -- Fig. 4a/4c) and drives one sleep transistor per sector index.  A
sleep transistor gates N sectors, one per bank (Fig. 6/8), so the gating
granularity of a memory is ``1 / sectors_per_bank`` of its capacity.

The model follows the paper's two-state scheme (ON at full swing, OFF at
zero voltage -- no retention states) with a 2-way handshake whose cost is a
wakeup energy + latency per ``OFF -> ON`` transition (Fig. 9).  Transitions
only happen at operation boundaries, which is why the paper (and this
model) finds the wakeup overhead negligible.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.energy import SRAMConfig, cycles_to_s


@dataclasses.dataclass(frozen=True)
class PhaseRequirement:
    """One operation's demand on one memory."""

    name: str
    required_bytes: float
    duration_cycles: float


@dataclasses.dataclass(frozen=True)
class PhaseState:
    name: str
    on_fraction: float          # sector-quantized fraction powered ON
    sectors_on: int
    sectors_woken: int          # OFF->ON transitions entering this phase
    duration_s: float
    leakage_mj: float
    wakeup_mj: float
    wakeup_latency_cycles: float


@dataclasses.dataclass(frozen=True)
class PMUSchedule:
    memory: SRAMConfig
    phases: tuple[PhaseState, ...]

    @property
    def static_mj(self) -> float:
        return sum(p.leakage_mj for p in self.phases)

    @property
    def wakeup_mj(self) -> float:
        return sum(p.wakeup_mj for p in self.phases)

    @property
    def wakeup_latency_cycles(self) -> float:
        return sum(p.wakeup_latency_cycles for p in self.phases)

    @property
    def total_transitions(self) -> int:
        return sum(p.sectors_woken for p in self.phases)


def schedule_from_plan(memory: SRAMConfig, plan) -> PMUSchedule:
    """PMU schedule for ``memory`` driven by an ``ExecutionPlan``.

    ``plan`` is any object with a ``phase_requirements()`` method (see
    ``repro_torch.core.execplan.ExecutionPlan``); this is the path by which the
    gating model scores the SAME per-operation schedule the kernels
    execute, instead of a hand-built phase list.  The plan emits one
    phase per EXECUTED kernel, so a fused op (the votes+routing
    megakernel) is gated as the single phase it actually runs -- no
    spurious sector transitions at fused-away operation boundaries.  A
    training plan (``compile_plan(train=True)``) appends one phase per
    backward kernel in reverse network order, so the same schedule gates
    a full training step.
    """
    return build_schedule(memory, plan.phase_requirements())


def build_schedule(memory: SRAMConfig,
                   phases: Sequence[PhaseRequirement]) -> PMUSchedule:
    """Derive the sector ON/OFF schedule for one memory across the inference.

    All sectors start OFF (gated) for a power-gated memory; a non-gated
    memory is always fully ON.  The PMU wakes exactly the sectors an
    operation needs and gates the rest down at the boundary.
    """
    states: list[PhaseState] = []
    prev_on = 0
    total_sectors = memory.sectors_per_bank  # per-bank index granularity
    for ph in phases:
        if memory.capacity_bytes <= 0:
            wanted = 0.0
        else:
            wanted = min(ph.required_bytes / memory.capacity_bytes, 1.0)
        if memory.power_gated:
            frac = memory.quantize_on_fraction(wanted)
        else:
            frac = 1.0
        sectors_on = round(frac * total_sectors)
        woken = max(sectors_on - prev_on, 0)
        dur = cycles_to_s(ph.duration_cycles)
        leak_mw = memory.leakage_mw(on_fraction=frac)
        states.append(PhaseState(
            name=ph.name,
            on_fraction=frac,
            sectors_on=sectors_on,
            sectors_woken=woken if memory.power_gated else 0,
            duration_s=dur,
            leakage_mj=leak_mw * dur,  # mW * s = mJ
            wakeup_mj=memory.wakeup_energy_pj(woken) * 1e-9
            if memory.power_gated else 0.0,
            wakeup_latency_cycles=memory.wakeup_latency_cycles(woken)
            if memory.power_gated else 0.0,
        ))
        prev_on = sectors_on
    return PMUSchedule(memory=memory, phases=tuple(states))
