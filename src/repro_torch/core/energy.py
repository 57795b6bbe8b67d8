"""CACTI-P-flavoured analytical energy/area model (32 nm) for CapStore.

The counterpart of ``repro/core/energy.py``, the same constants: they
model the paper's 32 nm accelerator, not the GPU the port runs on.

The paper evaluates SRAM organizations with CACTI-P [9] and synthesizes the
CapsAcc accelerator in a 32 nm CMOS library.  Neither tool is available
offline, so this module implements an analytical model with the same
structure CACTI-P exposes (per-access dynamic energy, leakage power, area,
all scaling with capacity / ports / banks) and constants calibrated so the
paper's published headline results reproduce.  Every constant is a named module-level value so the
calibration is explicit and auditable.

Units: energy pJ, power mW, time s, area mm^2, capacity bytes.
"""

from __future__ import annotations

import dataclasses
import math

# --------------------------------------------------------------------------
# Technology constants (32 nm, calibrated against CapStore Table 2 / Fig 5).
# --------------------------------------------------------------------------

CLOCK_HZ: float = 250e6          # CapsAcc operating frequency
REFERENCE_CAP_BYTES: float = 64 * 1024

# SRAM dynamic energy per access of one word (we charge per element access;
# element width is folded into the access counts produced by analysis.py).
SRAM_E0_PJ: float = 6.0          # per access at 64 KiB, single port
SRAM_CAP_EXP: float = 0.5        # E ~ sqrt(capacity): longer bit/word-lines
# Multi-port SRAM access energy grows super-linearly (every port adds
# bitline/wordline capacitance to every access): (1 + f*(p-1))^2, as CACTI's
# multiported models do.
SRAM_PORT_DYN_FACTOR: float = 0.7
SRAM_WRITE_FACTOR: float = 1.10      # writes slightly costlier than reads

# SRAM leakage power (dominant at multi-MB sizes -> drives the 8 MB result).
SRAM_LEAK_MW_PER_64K: float = 18.0
SRAM_PORT_LEAK_FACTOR: float = 1.0   # extra leakage per extra port (linear)
SRAM_PG_RESIDUAL: float = 0.03       # fraction of leakage left when gated OFF

# SRAM area.
SRAM_A0_MM2: float = 0.145           # 64 KiB single-port bank @32 nm
SRAM_PORT_AREA_FACTOR: float = 0.85  # per extra port (interconnect overhead)
SRAM_BANK_AREA_OVERHEAD: float = 0.035   # per extra bank (decoders, routing)
# Sleep-transistor area is charged per gated byte; the paper's PG variants
# pay a large area premium (PG-SMP is ~3x SMP in Table 2).
PG_AREA_FACTOR: float = 1.9          # sleep transistors + PMU wiring
PG_WAKEUP_PJ_PER_BYTE: float = 0.012  # energy to recharge a gated sector
PG_WAKEUP_CYCLES_PER_KB: float = 0.9  # latency of the 2-way handshake

# Off-chip DRAM (LPDDR-class), per element access as counted by analysis.py.
DRAM_E_PJ: float = 150.0
DRAM_STATIC_MW: float = 20.0         # background + refresh power
DRAM_BYTES_PER_CYCLE: float = 16.0   # interface bandwidth at CLOCK_HZ

# Accelerator (16x16 PE array + activation + control), from "synthesis":
# ~0.7 pJ/MAC at 32 nm plus a fixed idle power; area from the CapsAcc paper.
PE_MAC_PJ: float = 0.7
ACCEL_STATIC_MW: float = 24.0
ACCEL_AREA_MM2: float = 28.0         # 256 PEs + activation/control, 32 nm
# Small pipeline buffers between array and memories (Fig 3 "buffers").
BUFFER_E_PJ: float = 0.9             # per element access
BUFFER_AREA_MM2: float = 3.0


@dataclasses.dataclass(frozen=True)
class SRAMConfig:
    """One physical SRAM: capacity, ports, banking and power-gating."""

    name: str
    capacity_bytes: int
    ports: int = 1
    banks: int = 16
    sectors_per_bank: int = 1
    power_gated: bool = False

    @property
    def sector_bytes(self) -> float:
        return self.capacity_bytes / (self.banks * self.sectors_per_bank)

    # -- dynamic ----------------------------------------------------------
    def access_energy_pj(self, write: bool = False) -> float:
        if self.capacity_bytes == 0:
            return 0.0
        # Banking shortens word/bit lines: the accessed bank is what matters.
        bank_bytes = self.capacity_bytes / self.banks
        scale = (max(bank_bytes, 256.0) / REFERENCE_CAP_BYTES) ** SRAM_CAP_EXP
        port = (1.0 + SRAM_PORT_DYN_FACTOR * (self.ports - 1)) ** 2
        e = SRAM_E0_PJ * scale * port
        if write:
            e *= SRAM_WRITE_FACTOR
        return e

    # -- static -----------------------------------------------------------
    def leakage_mw(self, on_fraction: float = 1.0) -> float:
        """Leakage with `on_fraction` of the capacity powered.

        Without power gating the whole array leaks regardless of use.
        """
        if self.capacity_bytes == 0:
            return 0.0
        full = (
            SRAM_LEAK_MW_PER_64K
            * (self.capacity_bytes / REFERENCE_CAP_BYTES)
            * (1.0 + SRAM_PORT_LEAK_FACTOR * (self.ports - 1))
        )
        if not self.power_gated:
            return full
        on_fraction = min(max(on_fraction, 0.0), 1.0)
        # Gated-OFF sectors retain a small residual leakage.
        return full * (on_fraction + SRAM_PG_RESIDUAL * (1.0 - on_fraction))

    def quantize_on_fraction(self, wanted: float) -> float:
        """Round the wanted ON fraction up to whole sectors (granularity)."""
        total = self.banks * self.sectors_per_bank
        if self.capacity_bytes == 0 or total <= 0:
            return 0.0
        # Sector-index gating spans all banks (one sleep transistor per
        # sector index, paper Sec. 4.1) -> granularity is 1/sectors_per_bank.
        steps = self.sectors_per_bank
        return min(1.0, math.ceil(max(wanted, 0.0) * steps) / steps)

    # -- power gating transitions ------------------------------------------
    def wakeup_energy_pj(self, sectors_woken: int) -> float:
        if not self.power_gated or sectors_woken <= 0:
            return 0.0
        # One sleep transistor wakes `banks` sectors (one per bank).
        return PG_WAKEUP_PJ_PER_BYTE * self.sector_bytes * self.banks * sectors_woken

    def wakeup_latency_cycles(self, sectors_woken: int) -> float:
        if not self.power_gated or sectors_woken <= 0:
            return 0.0
        kb = self.sector_bytes * self.banks / 1024.0
        return PG_WAKEUP_CYCLES_PER_KB * kb  # sectors wake in parallel

    # -- area ---------------------------------------------------------------
    def area_mm2(self) -> float:
        if self.capacity_bytes == 0:
            return 0.0
        base = SRAM_A0_MM2 * (self.capacity_bytes / REFERENCE_CAP_BYTES)
        base *= (1.0 + SRAM_PORT_AREA_FACTOR * (self.ports - 1)) ** 2
        base *= 1.0 + SRAM_BANK_AREA_OVERHEAD * max(self.banks - 1, 0)
        if self.power_gated:
            base *= 1.0 + PG_AREA_FACTOR
        return base


def dram_energy_pj(accesses: float) -> float:
    return DRAM_E_PJ * accesses


def dram_static_mj(duration_s: float) -> float:
    return DRAM_STATIC_MW * duration_s  # mW * s = mJ


def accelerator_dynamic_mj(macs: float) -> float:
    return PE_MAC_PJ * macs * 1e-9


def accelerator_static_mj(duration_s: float) -> float:
    return ACCEL_STATIC_MW * duration_s  # mW * s = mJ


def buffer_energy_mj(accesses: float) -> float:
    return BUFFER_E_PJ * accesses * 1e-9


def pj_to_mj(pj: float) -> float:
    return pj * 1e-9


def cycles_to_s(cycles: float) -> float:
    return cycles / CLOCK_HZ
