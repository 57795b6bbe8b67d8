"""CapStore planner for Hopper: the paper's DSE over the CUDA GEMM's tiles.

The counterpart of ``repro/core/planner.py``.  The ASIC paper sizes its
on-chip memories to each operation's working set; on an H100 the on-chip
memory a kernel sizes is the shared memory of one thread block (CTA), at
most 232,448 B.  ``matmul_bias_act`` (K2) runs on the shared GEMM core of
``csrc/gemm_sm90.cuh``, whose footprint is a ring of ``GEMM_STAGES``
stages of

    data tile   : block_m x block_k     (A, K-major, as in memory)
    weight tile : block_k x block_n     (B)

and, for the squash epilogue with one split only, the output tile
``block_m x (block_n + 1)`` staged over the ring.  Its device-memory
traffic follows from how often each operand is re-read, plus the
partials of a split K (written once and read once).  The DSE minimises
the paper's energy objective

    E = e_hbm * HBM_bytes + e_smem * smem_accesses
        + leak * smem_resident_bytes * est_cycles

over the tile shapes the kernel is built for: block_m and block_n of 64
or 128 (16 threads x 4 or 8 accumulators), block_k of 16.  The output
tile's width must be a multiple of ``n_multiple`` (the capsule size when
the squash epilogue is fused), so each candidate width is rounded down
to one.

The paper's objective scores bytes, not the card's occupancy: on the TPU
one core walked every tile.  An H100 has 132 SMs, and a GEMM with a few
output tiles and a long K (PrimaryCaps: 6 tiles of 128 x 128 at MNIST
batch 8, K = 20,736) leaves most of them idle.  So for each tile shape
the planner also picks ``split_k``, the number of CTAs that share one
tile's K: at least one CTA per SM where K allows it, and among those the
split of least modeled time (``gemm_seconds``): whole waves of
``NUM_SMS`` CTAs, each its slab's flops at ``GEMM_EFFICIENCY`` of one
SM's share of the fp32 peak plus ``CTA_FIXED_S``, then the partials'
bytes at the HBM rate.  Each split takes a slab of K that is a multiple
of block_k and at least ``SPLIT_K_MIN`` long, and none is empty; a tile
grid that already fills the card, or a short K (Conv1's 81 or 243, the
dpatches GEMM's 256), keeps ``split_k = 1``.  ``est_cycles`` is that
modeled time.

``matmul_at_b`` (K6) runs on the same core on 128 x 128 tiles of its
[K, N] output.  ``at_b_plan`` schedules it by the same model: either
every tile over the whole reduction -- those rows of tiles that fill
whole waves on 128 x 128 tiles, the rest on 128 x 64 tiles of half the
work in a second launch, so the last wave is half as long -- or, where
the tiles alone cannot fill the card, the reduction split as K2 splits
K.
"""

from __future__ import annotations

import dataclasses
import functools
import math

SMEM_BYTES = 232_448         # shared memory one CTA may use on an H100
TILE_MN = (64, 128)          # matmul_bias_act's block_m / block_n builds
TILE_K = (16,)               # its block_k
GEMM_STAGES = 3              # csrc/gemm_sm90.cuh kStages
ELEM_BYTES = 4
NUM_SMS = 132                # streaming multiprocessors of an H100 SXM
CLOCK_HZ = 1.98e9            # its boost clock (cycle estimate only)
# NVIDIA H100 SXM data sheet, dense: fp32 outside the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# The core's measured share of an SM's fp32 peak, and one launch's fixed
# cost (ring fill, epilogue, the reduction's launch), fitted to K2's
# split sweep on the H100 (chip_smoke.py prints it; PERF.md).
GEMM_EFFICIENCY = 0.55
CTA_FIXED_S = 8e-6
SPLIT_K_MIN = 256            # fewest K elements one split of K2 takes

# matmul_at_b (K6, csrc/conv_bwd.cu): an AT_B_TILE_K x AT_B_TILE_N output
# tile per CTA (AT_B_TILE_K x AT_B_NARROW_N past the plan's wide rows), the
# reduction walked AT_B_STEP rows per ring stage, each stage summed apart
# and added, as the TPU kernel adds each M block.
AT_B_TILE_K = 128
AT_B_TILE_N = 128
AT_B_NARROW_N = 64
AT_B_STEP = 16
AT_B_MIN_ROWS = 64           # fewest reduction rows one split takes
AT_B_SMEM_BYTES = (GEMM_STAGES * AT_B_STEP * (AT_B_TILE_K + AT_B_TILE_N)
                   * ELEM_BYTES)

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
    hbm_bytes: float         # operands, output and split-K partials
    energy: float
    split_k: int             # CTAs sharing one output tile's K
    ctas: int                # tiles_m x tiles_n x split_k

    @property
    def tiles(self) -> tuple[int, int, int, int]:
        """``(block_m, block_k, block_n, split_k)``, as the conv wrappers
        take them."""
        return self.block_m, self.block_k, self.block_n, self.split_k


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
    """Shared memory of one ``matmul_bias_act`` CTA (see the module note):
    ``stage_output`` when the squash epilogue runs in the GEMM (one
    split)."""
    bn = gemm_tile_n(block_n)
    floats = GEMM_STAGES * block_k * (block_m + bn)
    if stage_output:
        floats = max(floats, block_m * (bn + 1))
    return floats * ELEM_BYTES


def split_slab(k: int, split: int, step: int) -> tuple[int, int]:
    """``(split, slab)``: K cut into at most ``split`` slabs of ``slab``
    (a multiple of ``step``), the count lowered until none is empty."""
    steps = math.ceil(k / step)
    split = max(1, min(split, steps))
    slab = math.ceil(steps / split) * step
    return math.ceil(k / slab), slab


def cta_seconds(block_m: int, block_n: int, depth: int) -> float:
    """Modeled time of one CTA: its tile's flops over ``depth`` of K."""
    return CTA_FIXED_S + 2.0 * block_m * block_n * depth / (
        GEMM_EFFICIENCY * PEAK_FP32_FLOPS / NUM_SMS)


def gemm_seconds(m: int, n: int, block_m: int, block_n: int, split: int,
                 slab: int) -> float:
    """Modeled run of a split GEMM: whole waves of one CTA per SM, then
    the partials (written once, read once)."""
    ctas = math.ceil(m / block_m) * math.ceil(n / block_n) * split
    partials = (2.0 * split * m * n * ELEM_BYTES / PEAK_HBM_BYTES
                if split > 1 else 0.0)
    return (math.ceil(ctas / NUM_SMS) * cta_seconds(block_m, block_n, slab)
            + partials)


def choose_split(m: int, n: int, k: int, block_m: int, block_n: int,
                 step: int) -> tuple[int, int]:
    """K2's ``(split, slab)``: the splits whose slabs are at least
    ``SPLIT_K_MIN`` long; of those that give at least ``NUM_SMS`` CTAs
    (if any does), the one of least ``gemm_seconds``, fewest splits on a
    tie."""
    tiles = math.ceil(m / block_m) * math.ceil(n / block_n)
    options = {split_slab(k, want, step)
               for want in range(1, max(1, k // SPLIT_K_MIN) + 1)}
    filled = [o for o in options if tiles * o[0] >= NUM_SMS]
    return min(filled or options, key=lambda o: (
        gemm_seconds(m, n, block_m, block_n, *o), o[0]))


@dataclasses.dataclass(frozen=True)
class AtbPlan:
    """K6's schedule.  ``splits > 1``: every 128 x 128 tile takes
    ``splits`` CTAs of ``rows`` reduction rows.  ``splits == 1``: output
    rows below ``wide_rows`` run on 128 x 128 tiles, the rest on 128 x 64
    tiles in a second launch.  ``ctas`` counts both launches."""

    splits: int
    rows: int
    wide_rows: int
    ctas: int


@functools.lru_cache(maxsize=256)
def at_b_plan(m: int, k: int, n: int) -> AtbPlan:
    """Least modeled time schedule of ``matmul_at_b`` (a [M, K]^T b
    [M, N]): whole waves of one CTA per SM (``gemm_seconds``'s model).
    Either every tile over all of M -- on 128 x 128 tiles, or on them for
    as many rows of tiles as fill whole waves and 128 x 64 tiles, of half
    the work, after them -- or each tile's M split into slabs of at least
    ``AT_B_MIN_ROWS`` rows, a multiple of ``AT_B_STEP``, none empty."""
    tiles_m = math.ceil(k / AT_B_TILE_K)
    tiles_n = math.ceil(n / AT_B_TILE_N)
    narrow_n = math.ceil(n / AT_B_NARROW_N)
    all_rows = math.ceil(m / AT_B_STEP) * AT_B_STEP
    t_wide = cta_seconds(AT_B_TILE_K, AT_B_TILE_N, m)
    t_narrow = cta_seconds(AT_B_TILE_K, AT_B_NARROW_N, m)
    options = []
    full_waves = tiles_m * tiles_n // NUM_SMS * NUM_SMS // tiles_n
    for wide in sorted({tiles_m, min(full_waves, tiles_m)}):
        narrow = (tiles_m - wide) * narrow_n
        t = (math.ceil(wide * tiles_n / NUM_SMS) * t_wide
             + math.ceil(narrow / NUM_SMS) * t_narrow)
        options.append((t, AtbPlan(1, all_rows, min(wide * AT_B_TILE_K, k),
                                   wide * tiles_n + narrow)))
    most = min(m // AT_B_MIN_ROWS,                  # two CTAs an SM
               math.ceil(2 * NUM_SMS / (tiles_m * tiles_n)))
    for want in range(2, most + 1):
        splits, rows = split_slab(m, want, AT_B_STEP)
        options.append((
            gemm_seconds(k, n, AT_B_TILE_K, AT_B_TILE_N, splits, rows),
            AtbPlan(splits, rows, k, tiles_m * tiles_n * splits)))
    return min(options, key=lambda o: (o[0], o[1].ctas))[1]


def n_candidates(n_multiple: int = 1) -> list[int]:
    """Output-tile widths whose capsule groups never straddle a tile."""
    return sorted({t // n_multiple * n_multiple for t in TILE_MN
                   if t >= n_multiple})


def plan_matmul(w: MatmulWorkload, smem_budget: int = SMEM_BYTES, *,
                n_multiple: int = 1,
                stage_output: bool = False) -> BlockPlan:
    """Paper-style DSE over tile shapes, each with its occupancy split
    (see the module note); returns the energy-argmin plan.
    ``stage_output``: the squash epilogue is fused (it stages the output
    tile when the plan keeps one split).  Raises ``ValueError`` when no
    tile fits the budget or no width is a multiple of ``n_multiple``."""
    best: BlockPlan | None = None
    for bm in TILE_MN:
        for bk in TILE_K:
            for bn in n_candidates(n_multiple):
                split, slab = choose_split(w.m, w.n, w.k, bm, bn, bk)
                smem = gemm_smem_bytes(bm, bk, bn,
                                       stage_output=stage_output
                                       and split == 1)
                if smem > smem_budget:
                    continue
                tiles_m = math.ceil(w.m / bm)
                tiles_k = math.ceil(w.k / bk)
                tiles_n = math.ceil(w.n / bn)
                # A is re-read once per column of output tiles, B once per
                # row; masked (out-of-range) rows are never loaded.  The
                # partials of a split K are written once and read once.
                hbm = ELEM_BYTES * (w.m * w.k * tiles_n + w.k * w.n * tiles_m
                                    + w.m * w.n)
                if split > 1:
                    hbm += 2 * split * w.m * w.n * ELEM_BYTES
                smem_acc = (2.0 * tiles_m * tiles_n * tiles_k
                            * (bm * bk + bk * bn))
                cycles = gemm_seconds(w.m, w.n, bm, bn, split, slab) \
                    * CLOCK_HZ
                e = E_HBM * hbm + E_SMEM * smem_acc + E_LEAK * smem * cycles
                plan = BlockPlan(bm, bk, bn, smem, hbm, e, split,
                                 tiles_m * tiles_n * split)
                if best is None or plan.energy < best.energy:
                    best = plan
    if best is None:
        raise ValueError(
            f"no tile of block_n a multiple of {n_multiple} fits the "
            f"{smem_budget} B shared-memory budget for {w}")
    return best
