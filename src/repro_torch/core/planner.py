"""CapStore planner for Hopper: the paper's DSE over the CUDA GEMM's tiles.

The counterpart of ``repro/core/planner.py``.  The ASIC paper sizes its
on-chip memories to each operation's working set; on an H100 the on-chip
memory a kernel sizes is the shared memory of one thread block (CTA), at
most 232,448 B.  ``matmul_bias_act``'s footprint is

    data tile   : block_k x (block_m + 1)    (A tile, stored transposed,
                                              padded against bank conflicts)
    weight tile : block_k x block_n          (B tile)
    output tile : block_m x (block_n + 1)    (squash epilogue only; it
                                              reuses the tiles' space)

and its device-memory traffic follows from how often each operand is
re-read.  The DSE minimises the paper's energy objective

    E = e_hbm * HBM_bytes + e_smem * smem_accesses
        + leak * smem_resident_bytes * est_cycles

over the tile shapes the kernel is built for: warp-aligned block_m and
block_n (32, 64, 128), block_k of 8, 16 or 32.  The output tile's width
must be a multiple of ``n_multiple`` (the capsule size when the squash
epilogue is fused), so each candidate width is rounded down to one.
"""

from __future__ import annotations

import dataclasses
import math

SMEM_BYTES = 232_448         # shared memory one CTA may use on an H100
FP32_LANES = 128             # fp32 FMA units per SM (cycle estimate only)
TILE_MN = (32, 64, 128)      # matmul_bias_act's block_m / block_n builds
TILE_K = (8, 16, 32)         # its block_k choices
ELEM_BYTES = 4

# Relative energy weights (only their ratios matter for the argmin).
E_HBM = 1.0
E_SMEM = 0.02
E_LEAK = 1e-9      # per resident byte-cycle


@dataclasses.dataclass(frozen=True)
class MatmulWorkload:
    """[M, K] x [K, N] in fp32."""

    m: int
    k: int
    n: int

    @property
    def flops(self) -> float:
        return 2.0 * self.m * self.k * self.n


@dataclasses.dataclass(frozen=True)
class BlockPlan:
    block_m: int
    block_k: int
    block_n: int
    smem_bytes: int          # the CTA's shared-memory footprint
    hbm_bytes: float
    energy: float


def gemm_tile_n(block_n: int) -> int:
    """The kernel build that serves an output-tile width: the smallest
    of ``TILE_MN`` that holds it (its extra columns are masked)."""
    for t in TILE_MN:
        if t >= block_n:
            return t
    raise ValueError(f"block_n={block_n} exceeds the widest build "
                     f"({TILE_MN[-1]})")


def gemm_smem_bytes(block_m: int, block_k: int, block_n: int, *,
                    stage_output: bool = False) -> int:
    """Shared memory of one ``matmul_bias_act`` CTA (see the module note)."""
    bn = gemm_tile_n(block_n)
    tiles = block_k * (block_m + 1) + block_k * bn
    if stage_output:
        tiles = max(tiles, block_m * (bn + 1))
    return tiles * ELEM_BYTES


def n_candidates(n_multiple: int = 1) -> list[int]:
    """Output-tile widths whose capsule groups never straddle a tile."""
    return sorted({t // n_multiple * n_multiple for t in TILE_MN
                   if t >= n_multiple})


def plan_matmul(w: MatmulWorkload, smem_budget: int = SMEM_BYTES, *,
                n_multiple: int = 1,
                stage_output: bool = False) -> BlockPlan:
    """Paper-style DSE over tile shapes; returns the energy-argmin plan.
    Raises ``ValueError`` when no tile fits the budget or no width is a
    multiple of ``n_multiple``."""
    best: BlockPlan | None = None
    for bm in TILE_MN:
        for bk in TILE_K:
            for bn in n_candidates(n_multiple):
                smem = gemm_smem_bytes(bm, bk, bn, stage_output=stage_output)
                if smem > smem_budget:
                    continue
                tiles_m = math.ceil(w.m / bm)
                tiles_k = math.ceil(w.k / bk)
                tiles_n = math.ceil(w.n / bn)
                # A is re-read once per column of output tiles, B once per
                # row; masked (out-of-range) rows are never loaded.
                hbm = ELEM_BYTES * (w.m * w.k * tiles_n + w.k * w.n * tiles_m
                                    + w.m * w.n)
                smem_acc = (2.0 * tiles_m * tiles_n * tiles_k
                            * (bm * bk + bk * bn))
                cycles = w.flops / (2 * FP32_LANES)
                e = E_HBM * hbm + E_SMEM * smem_acc + E_LEAK * smem * cycles
                plan = BlockPlan(bm, bk, bn, smem, hbm, e)
                if best is None or plan.energy < best.energy:
                    best = plan
    if best is None:
        raise ValueError(
            f"no tile of block_n a multiple of {n_multiple} fits the "
            f"{smem_budget} B shared-memory budget for {w}")
    return best
