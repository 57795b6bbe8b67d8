"""ExecutionPlan for Hopper: one compiled schedule the kernels execute.

The forward half of ``repro/core/execplan.py``, derived again for an
H100.  ``compile_plan`` turns a ``CapsNetConfig`` into one ``OpPlan`` per
executed kernel call, with the reference's op names:

  Conv1, PrimaryCaps   ``conv_im2col``: patch extraction (K1) + the tiled
                       GEMM (K2) over ``planner.plan_matmul``'s tiles and
                       K split (PrimaryCaps's long K is cut across CTAs
                       so the grid fills the card; its partials count in
                       the op's global bytes).
                       PrimaryCaps fuses the capsule squash into the GEMM
                       epilogue when a tile width that is a multiple of
                       the capsule size exists (every capsule up to 128
                       floats); a wider capsule plans the plain GEMM and
                       the standalone squash (K10) over ``block_rows``
                       rows per CTA.
  ClassCaps-Routing    ``votes_routing``: votes + every routing iteration,
                       each sample on a thread-block cluster (a
                       ``ClusterPlan`` block): K3 (``resident``) with the
                       votes of each CTA's rows on chip, K4 (``streamed``
                       or ``streamed-global``) recomputing them from W on
                       every pass.
  PrimaryCaps-Routing  ``primary_routing`` (K5, ``pipeline=True``):
                       PrimaryCaps + the first routing layer in one
                       kernel, each sample on a thread-block cluster, u
                       kept in the cluster's shared memory.

The budget is the shared memory of one CTA (``planner.SMEM_BYTES``), not
the TPU's VMEM.  The routing kernels run one cluster per sample, so their
footprints do not grow with the batch; a schedule that fits, fits at
every batch.  ``resident`` computes the votes once and keeps them in
shared memory, each cluster CTA its rows', while ``streamed`` keeps u and
the logits of its rows and recomputes the votes from W on each of the
``iters + 1`` passes, ``block_i`` rows at a time.  For each cluster size
the forward takes resident votes where a CTA's rows' votes fit (K3: the
SVHN ResCaps halves and ClassCaps, MNIST's ClassCaps from 4 CTAs up),
else streamed (K4: the SVHN bottleneck, whose 2048 x 64 logits, 524 KB a
sample, fit a CTA from 4 CTAs up), else ``streamed-global`` (K4g):
streamed with the CTA's rows' logits in a per-sample scratch in global
memory (B*I*J floats, which stay in the 50 MB L2), only where even a
16-CTA cluster's share of them fits no CTA (CIFAR-10's full-width halves,
64 rows x 1024 logits).  It does the same arithmetic in the same order
as ``streamed``.  ``streamed-2pass`` (K13, the unfused schedule: a
b-pass and an s-pass per iteration, on K4's cluster) is the oracle of the
fused pass and never a plan mode; ``ExecutionPlan.validate`` rejects it.

Cluster schedules (K3/K4, K5, K14b and K8/K9 below): one sample runs on
a cluster of ``cs`` CTAs (``CLUSTER_SIZES``), each owning a share of its
capsule rows and keeping their u and logits in its own shared memory
(K4g: the logits in global memory); only s (and in
the backward dv) crosses CTAs, summed in rank order through distributed
shared memory once a pass (``csrc/routing_cluster.cuh``).  Such an op's
``block`` is a ``ClusterPlan``, and its ``mode`` says where each CTA keeps
its rows' votes: ``resident`` (computed once) or ``streamed`` (recomputed
from W on every pass, ``block_i`` rows at a time).  ``cs`` is chosen by
``cluster_seconds``: whole waves of co-resident clusters
(``MAX_ACTIVE_CLUSTERS``, from ``cudaOccupancyMaxActiveClusters`` on the
H100: a 16-CTA cluster needs 16 free SMs in one GPC; times the CTAs an SM
holds, ``ctas_per_sm``), each as long as one CTA's share of the sample's
operations and L2 bytes plus a cluster barrier a pass;
``chip_smoke.py`` sweeps ``cs`` beside the model.  K5's ``cs`` divides the
capsule groups, so a CTA owns whole groups at every position; at MNIST
width the CTAs' rows' votes fit, so the consume is ``resident`` as in the
reference's plan, and at SVHN's bottleneck the logits of a CTA's rows fit,
so the pipelined plan exists there too.

The split ClassCaps path -- ``caps_votes`` (K14a) writing u_hat to
device memory, then ``routing`` (K14b, a cluster a sample) reading it
back -- is the paper's baseline and never a plan op; ``plan_caps_votes``
and ``plan_routing_split`` give its schedules,
``split_votes_routing_global_bytes`` its traffic, for the comparison with
the fused op.

``compile_plan(train=True)`` appends one backward op per executed kernel,
named ``<op>-bwd`` and listed in reverse network order (the order the
backward runs), as the reference's training plans do:

  <routing>-bwd      ``votes_routing_bwd``: a per-sample replay on a
                     cluster (a ``ClusterPlan`` block; rows in contiguous
                     blocks of ceil(I / cs), votes ``resident`` -- K8 --
                     or ``streamed`` -- K9 -- in each CTA; s and dv summed
                     over the cluster), then a per-capsule emit CTA.  Each
                     cluster CTA keeps its rows' logits on chip, so the
                     backward has no ``streamed-global`` schedule of its
                     own: that name runs K9's ``streamed``.
  PrimaryCaps-bwd,   ``conv_im2col_bwd``: the forward tiles for the
  Conv1-bwd          recompute, K6 for dW, ``dx_block`` tiles for the
                     dpatches GEMM (K2) and K7 for dx.

A pipelined training plan runs the same backward ops: the pipelined
op's backward is the per-op backward (``kernels/primary_routing.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import math

from repro_torch.core.capsnet import ROUTING_NAME, CapsNetConfig
from repro_torch.core.planner import (AT_B_SMEM_BYTES, CTA_FIXED_S,
                                      ELEM_BYTES, GEMM_EFFICIENCY, NUM_SMS,
                                      PEAK_FP32_FLOPS, SMEM_BYTES, BlockPlan,
                                      MatmulWorkload, at_b_plan, plan_matmul)

FUSED_NAME = ROUTING_NAME
PIPE_NAME = "PrimaryCaps-Routing"
BWD_SUFFIX = "-bwd"
STREAMED_GLOBAL = "streamed-global"
MODES = ("resident", "streamed", STREAMED_GLOBAL)  # plan-chooseable
ORACLE_MODE = "streamed-2pass"           # unfused oracle (K13), tests only
ALL_MODES = MODES + (ORACLE_MODE,)

# Limits of primary_routing's produce phase (csrc/primary_routing.cu): the
# cluster splits K, and each CTA's threads hold the whole P x N tile of its
# slab, 4 columns and up to 16 rows each.
PIPE_MAX_POSITIONS = 64
PIPE_MAX_CHANNELS = 256
PIPE_ROWS_BUILT = (1, 2, 3, 4, 6, 8, 9, 12, 16)   # rows a thread, built
PIPE_BLOCK_K = 16            # K per ring stage
# The producer's cp.async ring: 3 to 16 stages, as deep as the consumer's
# region and at least PIPE_RING_FLOATS (64 KB): its L2 stream is bound by
# latency, so the bytes in flight set its rate.
PIPE_MIN_STAGES, PIPE_MAX_STAGES = 3, 16
PIPE_RING_FLOATS = 16_384
CTA_THREADS = 256            # csrc/common.cuh kThreads
BLOCK_I_CANDIDATES = (256, 128, 64, 32, 16, 8, 4, 2, 1)
# Thread-block cluster sizes of the cluster schedules (16 is non-portable).
CLUSTER_SIZES = (1, 2, 4, 8, 16)
# Clusters of each size an H100 SXM runs at once at one CTA an SM: what
# cudaOccupancyMaxActiveClusters reports there (chip_smoke.py prints it).
# A cluster takes its SMs from one GPC, so 132 SMs hold 15 of 8, 7 of 16.
MAX_ACTIVE_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}
# CTAs of a kernel one SM holds at once follow from its shared memory and
# its registers: an SM's 233,472 B and 65,536 registers; the registers a
# thread of K5 (161 to 207 by its rows a thread: one CTA an SM) and of the
# K3 and K8/K9 cluster kernels (each held to 128) take, as
# cudaFuncGetAttributes reports them.
SM_SMEM_BYTES = 233_472
SM_REGISTERS = 65_536
PIPE_REGISTERS = 161
ROUTING_CLUSTER_REGISTERS = 128
# One pass's cluster barrier, its rank-order sum of s (a DSMEM read of each
# CTA's partial, so its time grows with the cluster), the serial latency a
# pass spends on each of a CTA's capsule rows (the warp-a-row logits
# update and softmax, the s sum's dependent FMAs), and the bytes a second
# one SM draws from L2 on the votes' W stream.  Fitted to the cluster
# sweeps of K3, K5, K8 and K9 on the H100 (chip_smoke.py prints the model
# beside each size; PERF.md has the fit).
CLUSTER_SYNC_S = 1e-6
CLUSTER_RANK_S = 2e-7
ROUTING_ROW_S = 1e-7
L2_SM_BYTES_S = 12e9
# Samples the routing backward's emit CTA (csrc/votes_routing_bwd.cu)
# holds in shared memory at a time.
EMIT_CHUNK = 16
# Op name of the split path's votes (the reference's ``ClassCaps-FC``).
VOTES_NAME = "ClassCaps-FC"
WARP = 32
# Samples of u one caps_votes CTA (csrc/caps_votes.cu) stages at a time.
CAPS_VOTES_CHUNK = 64
# CUDA's limit on a grid's x dimension.
CUDA_MAX_GRID = 2**31 - 1


class PlanError(ValueError):
    """An ExecutionPlan cannot be built or violates one of its invariants."""


@dataclasses.dataclass(frozen=True)
class ClusterPlan:
    """One sample on a thread-block cluster: ``cluster`` CTAs, each owning
    up to ``rows`` capsule rows; ``ctas`` = batch x cluster, run in
    ``waves`` of co-resident clusters (``MAX_ACTIVE_CLUSTERS``)."""

    cluster: int
    rows: int
    ctas: int
    waves: int

    @property
    def tiles(self) -> tuple[int, int, int, int]:
        return self.cluster, self.rows, self.ctas, self.waves


@dataclasses.dataclass(frozen=True)
class OpPlan:
    """The compiled schedule of one kernel call.

    ``block`` holds the GEMM tiles of the conv ops, or the
    ``ClusterPlan`` of a cluster schedule (K3/K4, K5, K8/K9); ``block_i`` /
    ``mode`` / ``n_passes`` the routing schedule (the votes are computed
    from W ``n_passes`` times per sample); ``block_k`` the pipelined
    producer's K stage; ``dx_block`` a
    conv backward's dpatches GEMM tiles; ``block_rows`` the rows of one
    standalone-squash CTA (PrimaryCaps only).  ``smem_bytes`` is the
    modeled shared memory of one CTA, and ``global_bytes`` the bytes the op
    requests from global memory per call at the plan batch (served by L2
    where a re-read operand fits there).
    """

    name: str
    kernel: str
    block: BlockPlan | ClusterPlan | None
    smem_bytes: int
    global_bytes: float
    block_i: int | None = None
    mode: str | None = None
    n_passes: int | None = None
    block_k: int | None = None
    dx_block: BlockPlan | None = None
    block_rows: int | None = None

    @property
    def fuses_squash(self) -> bool:
        """Whether this op's epilogue absorbs the squash activation."""
        return self.kernel.endswith("+squash")

    @property
    def cluster(self) -> int | None:
        """CTAs per sample of a cluster schedule, else None."""
        return (self.block.cluster if isinstance(self.block, ClusterPlan)
                else None)


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    cfg: CapsNetConfig
    batch: int
    smem_budget: int
    ops: tuple[OpPlan, ...]
    train: bool = False

    def op(self, name: str) -> OpPlan:
        for op in self.ops:
            if op.name == name:
                return op
        raise KeyError(f"no operation {name!r} in plan "
                       f"({[o.name for o in self.ops]})")

    def bwd_op(self, name: str) -> OpPlan | None:
        """The backward op of ``name`` on a training plan, else None."""
        return self.op(name + BWD_SUFFIX) if self.train else None

    @property
    def pipelined(self) -> bool:
        return any(op.kernel == "primary_routing" for op in self.ops)

    def validate(self) -> None:
        """Check the plan invariants; raises ``PlanError`` on violation."""
        if self.batch < 1:
            raise PlanError(f"batch must be >= 1, got {self.batch}")
        names = [op.name for op in self.ops]
        layers = [lay.name for lay in self.cfg.routing_stack()]
        expected = (["Conv1", PIPE_NAME] + layers[1:] if self.pipelined
                    else ["Conv1", "PrimaryCaps"] + layers)
        if self.train:
            expected += [n + BWD_SUFFIX for n in
                         list(reversed(layers)) + ["PrimaryCaps", "Conv1"]]
        if names != expected:
            raise PlanError(f"plan ops {names}, expected {expected}")
        for op in self.ops:
            if op.mode == ORACLE_MODE:
                raise PlanError(f"{op.name}: {ORACLE_MODE!r} is the "
                                f"oracle schedule, never a plan mode")
            if op.mode is not None and op.mode not in MODES:
                raise PlanError(f"{op.name}: unknown mode {op.mode!r}")
            if op.smem_bytes > self.smem_budget:
                raise PlanError(
                    f"{op.name}: shared-memory footprint {op.smem_bytes} B "
                    f"exceeds the {self.smem_budget} B budget")

    def activation_residency_bytes(self, *, reversible: bool = True) -> int:
        """Routing-stack activation bytes a training step keeps live (see
        the module-level ``activation_residency_bytes``) at this plan's
        batch."""
        return activation_residency_bytes(self.cfg, batch=self.batch,
                                          reversible=reversible)

    def summary(self) -> list[dict]:
        def tiles(b):
            return b.tiles if b else None
        return [dict(name=op.name, kernel=op.kernel, block=tiles(op.block),
                     dx_block=tiles(op.dx_block), block_rows=op.block_rows,
                     block_i=op.block_i, block_k=op.block_k, mode=op.mode,
                     n_passes=op.n_passes, smem_kib=op.smem_bytes / 1024,
                     global_bytes=op.global_bytes)
                for op in self.ops]


def activation_residency_bytes(cfg: CapsNetConfig, *, batch: int = 1,
                               reversible: bool = True) -> int:
    """Modeled bytes of routing-stack activations a training step keeps
    live for the backward.

    ``reversible=False`` is the conventional autodiff accounting: every
    routing layer saves its input ``[B, in_caps, in_dim]``, so the total
    grows linearly in depth.  ``reversible=True`` is what the kernels
    backend runs: a maximal run of residual coupling halves is ONE
    reversible segment (``res_caps_segment``) that saves only its output
    (the backward inverts the couplings), so an all-residual stack costs
    one segment tensor however many blocks it chains.  Plain layers save
    their input either way.
    """
    stack = cfg.routing_stack()
    total, k = 0, 0
    while k < len(stack):
        lay = stack[k]
        if reversible and lay.residual:
            # x = [x1 | x2]: the F half consumes x2 and emits x1's width,
            # so the segment tensor is (in_caps + num_caps) capsules.
            seg_caps = lay.in_caps + lay.num_caps
            total += batch * seg_caps * lay.in_dim * ELEM_BYTES
            while k < len(stack) and stack[k].residual:
                k += 1
        else:
            total += batch * lay.in_caps * lay.in_dim * ELEM_BYTES
            k += 1
    return total


# ---------------------------------------------------------------------------
# Routing schedules (votes_routing and the consume phase of primary_routing)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class VotesRoutingSchedule:
    mode: str
    block_i: int
    smem_bytes: int
    n_passes: int            # votes reads per sample: 1 resident, iters+1 str.
    cluster: ClusterPlan | None = None    # its cluster (K3/K4, K8/K9, K14b)
    seconds: float = 0.0     # a cluster schedule's cluster_seconds


def _largest_fit(num_caps: int, smem_of) -> tuple[int, int] | None:
    """Largest i-tile (rows past I are skipped, never padded in memory)
    whose footprint fits, with that footprint."""
    for bi in BLOCK_I_CANDIDATES:
        bi = min(bi, num_caps)
        need = smem_of(bi)
        if need is not None:
            return bi, need
    return None


def plan_votes_routing(num_caps: int, caps_dim: int, jd: int, j: int, *,
                       iters: int = 3, batch: int = 1,
                       smem_budget: int = SMEM_BYTES,
                       name: str = FUSED_NAME) -> VotesRoutingSchedule:
    """Schedule of ``votes_routing``: the cluster schedule of
    ``plan_votes_routing_cluster`` at ``batch`` (for each cluster size
    resident votes, else streamed, else streamed-global; the least
    modeled time).  Raises ``PlanError`` naming the op when even a 16-CTA
    cluster streaming ``block_i=1`` with its logits in global memory does
    not fit."""
    sched = plan_votes_routing_cluster(num_caps, caps_dim, jd, j,
                                       iters=iters, batch=batch,
                                       smem_budget=smem_budget)
    if sched is not None:
        return sched
    cs = CLUSTER_SIZES[-1]
    need = votes_routing_cluster_smem(num_caps, caps_dim, j, jd, cs,
                                      mode=STREAMED_GLOBAL, block_i=1)
    raise PlanError(
        f"{name}: no feasible schedule: even {STREAMED_GLOBAL} block_i=1 on "
        f"a {cs}-CTA cluster needs {need} B of shared memory per CTA, over "
        f"the {smem_budget} B budget ({num_caps} capsules of {caps_dim}D -> "
        f"{jd})")


def votes_routing_global_bytes(batch: int, num_caps: int, caps_dim: int,
                               jd: int, n_passes: int,
                               logits_j: int = 0) -> float:
    """u read once, W read ``n_passes`` times per sample, v written once;
    with ``logits_j`` (J of a ``streamed-global`` schedule) the logits
    ``[I, J]`` are also read and written once per pass."""
    per_sample = (num_caps * caps_dim + n_passes * num_caps * jd * caps_dim
                  + jd + 2 * n_passes * num_caps * logits_j)
    return float(batch * per_sample * ELEM_BYTES)


# ---------------------------------------------------------------------------
# Cluster schedules: the model that picks the cluster size
# ---------------------------------------------------------------------------

def ctas_per_sm(smem: int, registers: int) -> int:
    """CTAs of ``CTA_THREADS`` threads with ``smem`` bytes of shared memory
    (plus the 1 KB the runtime reserves) and ``registers`` a thread that
    one SM holds at once."""
    return max(1, min(2048 // CTA_THREADS, SM_SMEM_BYTES // (smem + 1024),
                      SM_REGISTERS // (registers * CTA_THREADS)))


def cluster_waves(batch: int, cs: int, per_sm: int = 1) -> int:
    """Waves of a batch's clusters: ``MAX_ACTIVE_CLUSTERS[cs]`` at once,
    times the CTAs one SM holds."""
    return math.ceil(batch / (MAX_ACTIVE_CLUSTERS[cs] * per_sm))


def cluster_seconds(batch: int, cs: int, flops: float, nbytes: float,
                    passes: int, rows: int, per_sm: int = 1) -> float:
    """Modeled time of a per-sample cluster kernel at ``cs`` CTAs a
    sample: ``cluster_waves``, each as long as one CTA's work -- its share
    of the sample's ``flops`` at ``GEMM_EFFICIENCY`` of an SM's fp32
    share and of its ``nbytes`` at ``L2_SM_BYTES_S``, ``passes`` over its
    ``rows`` capsule rows, as many cluster barriers and rank-order sums of
    ``cs`` partials (none alone) -- and the launch."""
    rate = GEMM_EFFICIENCY * PEAK_FP32_FLOPS / NUM_SMS
    cta = (CTA_FIXED_S + (flops / rate + nbytes / L2_SM_BYTES_S) / cs
           + passes * rows * ROUTING_ROW_S
           + (passes * (CLUSTER_SYNC_S + cs * CLUSTER_RANK_S)
              if cs > 1 else 0.0))
    return cluster_waves(batch, cs, per_sm) * cta


def cluster_plan(batch: int, cs: int, rows: int,
                 per_sm: int = 1) -> ClusterPlan:
    return ClusterPlan(cluster=cs, rows=rows, ctas=batch * cs,
                       waves=cluster_waves(batch, cs, per_sm))


def routing_work(num_caps: int, caps_dim: int, jd: int, n_votes: int,
                 n_route: int) -> tuple[float, float]:
    """(flops, W bytes) of one sample's routing on a schedule that computes
    the votes ``n_votes`` times and makes ``n_route`` passes over the rows
    (couplings and s, or a backward's reverse rows)."""
    votes = 2.0 * num_caps * jd * caps_dim
    return (n_votes * votes + 4.0 * n_route * num_caps * jd,
            float(n_votes * num_caps * jd * caps_dim * ELEM_BYTES))


def votes_routing_cluster_smem(num_caps: int, caps_dim: int, j: int, jd: int,
                               cluster: int, *, mode: str = "resident",
                               block_i: int = 1) -> int:
    """Shared memory of one CTA of K3/K4's cluster (``csrc/votes_routing.cu``,
    ``cluster_fwd_layout``): the votes rows -- all of its ``ceil(I /
    cluster)`` rows when ``resident``, ``block_i`` of them when streamed --
    with their couplings, the rows' u and (except under
    ``streamed-global``) logits, and four [J*D] vectors (s, v and the two
    partials of s)."""
    rows = -(-num_caps // cluster)
    vrows = rows if mode == "resident" else min(block_i, rows)
    logits = 0 if mode == STREAMED_GLOBAL else rows * j
    return (vrows * (jd + 1 + j) + rows * caps_dim + logits
            + 4 * jd) * ELEM_BYTES


def _cluster_fit(rows: int, smem_of, block_i: int | None):
    """The i-tile of a cluster CTA's ``rows``: ``block_i`` clamped to them
    when given (with its footprint, None where it does not fit), else the
    largest that fits (``_largest_fit``)."""
    if block_i is None:
        return _largest_fit(rows, smem_of)
    bi = max(1, min(block_i, rows))
    need = smem_of(bi)
    return None if need is None else (bi, need)


def plan_votes_routing_cluster(num_caps: int, caps_dim: int, jd: int, j: int,
                               *, iters: int = 3, batch: int = 1,
                               smem_budget: int = SMEM_BYTES,
                               cluster: int | None = None,
                               votes: str | None = None,
                               block_i: int | None = None
                               ) -> VotesRoutingSchedule | None:
    """K3/K4's cluster schedule, the forward twin of
    ``plan_routing_bwd_cluster``: for each cluster size (only ``cluster``
    when given), resident votes in each CTA where they fit, else streamed
    at the largest i-tile that fits (``block_i`` when given), else
    streamed-global (the CTA's rows' logits in global memory) likewise;
    only the placement ``votes`` when given.  Of those, the least
    ``cluster_seconds`` at ``batch`` (resident: the votes once; streamed:
    once a pass, and under streamed-global the logits read and written
    once a pass), the smaller cluster on a tie.  None where no size
    fits."""
    placements = tuple(m for m in MODES if votes in (None, m))
    best = None
    for cs in (CLUSTER_SIZES if cluster is None else (cluster,)):
        rows = -(-num_caps // cs)
        for mode in placements:
            def smem_of(bi, mode=mode, cs=cs):
                need = votes_routing_cluster_smem(num_caps, caps_dim, j, jd,
                                                  cs, mode=mode, block_i=bi)
                return need if need <= smem_budget else None
            fit = _cluster_fit(rows, smem_of,
                               None if mode == "resident" else block_i)
            if fit is None:
                continue
            n_passes = 1 if mode == "resident" else iters + 1
            flops, w_bytes = routing_work(num_caps, caps_dim, jd, n_passes,
                                          iters + 1)
            if mode == STREAMED_GLOBAL:
                w_bytes += 2.0 * (iters + 1) * num_caps * j * ELEM_BYTES
            per_sm = ctas_per_sm(fit[1], ROUTING_CLUSTER_REGISTERS)
            t = cluster_seconds(batch, cs, flops, w_bytes, iters + 1, rows,
                                per_sm)
            if best is None or t < best.seconds:
                best = VotesRoutingSchedule(
                    mode=mode, block_i=rows if mode == "resident" else fit[0],
                    smem_bytes=fit[1], n_passes=n_passes,
                    cluster=cluster_plan(batch, cs, rows, per_sm), seconds=t)
            break
    return best


# ---------------------------------------------------------------------------
# The split path (K14a caps_votes -> K14b routing) and the standalone squash
# ---------------------------------------------------------------------------

def caps_votes_grid(num_caps: int, out_dim: int,
                    block_i: int) -> tuple[int, int]:
    """(CTAs, threads a CTA) of ``caps_votes`` (``csrc/caps_votes.cu``):
    a CTA takes ``block_i`` rows of I, their ``block_i * out_dim`` (i, n)
    columns, a thread a column at a time: as many threads as columns,
    rounded up to a warp, up to ``CTA_THREADS``."""
    cols = block_i * out_dim
    return -(-num_caps // block_i), min(CTA_THREADS, -(-cols // WARP) * WARP)


def caps_votes_smem(batch: int, block_i: int, caps_dim: int) -> int:
    """Shared memory of one ``caps_votes`` CTA: its rows of u for up to
    ``CAPS_VOTES_CHUNK`` samples at a time (W streams through
    registers)."""
    return min(batch, CAPS_VOTES_CHUNK) * block_i * caps_dim * ELEM_BYTES


def plan_caps_votes(num_caps: int, caps_dim: int, out_dim: int, batch: int,
                    smem_budget: int = SMEM_BYTES) -> int:
    """``block_i`` of ``caps_votes``: the most rows a CTA whose columns
    give each thread one (``block_i * out_dim <= CTA_THREADS``), whose
    grid still covers every SM and whose u rows fit the budget at this
    batch; else one row a CTA.  u is staged a chunk of samples at a
    time, so no batch is too large; raises ``PlanError`` naming
    ``ClassCaps-FC`` where even one row of ``caps_dim`` floats a sample
    does not fit, or the grid would pass CUDA's limit."""
    need = caps_votes_smem(batch, 1, caps_dim)
    if need > smem_budget:
        raise PlanError(
            f"{VOTES_NAME}: no feasible schedule at batch={batch}: even "
            f"block_i=1 needs {need} B of shared memory per CTA, over the "
            f"{smem_budget} B budget")
    bi = next((bi for bi in BLOCK_I_CANDIDATES
               if bi * out_dim <= CTA_THREADS
               and -(-num_caps // bi) >= NUM_SMS
               and caps_votes_smem(batch, bi, caps_dim) <= smem_budget), 1)
    if -(-num_caps // bi) > CUDA_MAX_GRID:
        raise PlanError(
            f"{VOTES_NAME}: no feasible schedule: {num_caps} capsules in "
            f"CTAs of {bi} need more than {CUDA_MAX_GRID} CTAs")
    return bi


def routing_split_cluster_smem(mode: str, num_caps: int, block_i: int,
                               j: int, jd: int, cluster: int) -> int:
    """Shared memory of one CTA of K14b's cluster (``csrc/routing.cu``,
    ``split_layout``): the u_hat rows -- all of its ``ceil(I / cluster)``
    rows when ``resident``, ``block_i`` of them when ``streamed`` -- padded
    to ``J*D + 1`` floats, with their couplings, the rows' logits, and four
    [J*D] vectors (s, v and the two partials of s); no u, since the votes
    come from device memory."""
    rows = -(-num_caps // cluster)
    vrows = rows if mode == "resident" else min(block_i, rows)
    return (vrows * (jd + 1 + j) + rows * j + 4 * jd) * ELEM_BYTES


def plan_routing_split(num_caps: int, j: int, jd: int, *, iters: int = 3,
                       batch: int = 1, smem_budget: int = SMEM_BYTES,
                       cluster: int | None = None, votes: str | None = None,
                       block_i: int | None = None) -> VotesRoutingSchedule:
    """K14b's schedule: for each cluster size (only ``cluster`` when
    given), each CTA's rows of u_hat copied on chip once (``resident``)
    where they fit, else ``streamed`` ``block_i`` rows a pass at the
    largest tile that fits (``block_i`` when given); only the placement
    ``votes`` when given.  Of those, the least ``cluster_seconds`` at
    ``batch`` (u_hat read once, or once a pass), the smaller cluster on a
    tie.  Raises ``PlanError`` when nothing fits."""
    best = None
    sizes = CLUSTER_SIZES if cluster is None else (cluster,)
    for cs in sizes:
        rows = -(-num_caps // cs)
        for mode in (m for m in ("resident", "streamed")
                     if votes in (None, m)):
            def smem_of(bi, mode=mode, cs=cs):
                need = routing_split_cluster_smem(mode, num_caps, bi, j, jd,
                                                  cs)
                return need if need <= smem_budget else None
            fit = _cluster_fit(rows, smem_of,
                               None if mode == "resident" else block_i)
            if fit is None:
                continue
            n_passes = 1 if mode == "resident" else iters + 1
            per_sm = ctas_per_sm(fit[1], ROUTING_CLUSTER_REGISTERS)
            t = cluster_seconds(batch, cs, 4.0 * (iters + 1) * num_caps * jd,
                                float(n_passes * num_caps * jd * ELEM_BYTES),
                                iters + 1, rows, per_sm)
            if best is None or t < best.seconds:
                best = VotesRoutingSchedule(
                    mode=mode, block_i=rows if mode == "resident" else fit[0],
                    smem_bytes=fit[1], n_passes=n_passes,
                    cluster=cluster_plan(batch, cs, rows, per_sm), seconds=t)
            break
    if best is None:
        need = routing_split_cluster_smem("streamed", num_caps, 1, j, jd,
                                          sizes[-1])
        raise PlanError(
            f"routing: no feasible schedule: even a {sizes[-1]}-CTA cluster "
            f"streaming block_i=1 needs {need} B of shared memory per CTA, "
            f"over the {smem_budget} B budget ({num_caps} capsules -> {jd})")
    return best


def split_votes_routing_global_bytes(batch: int, num_caps: int,
                                     caps_dim: int,
                                     jd: int) -> tuple[float, float]:
    """(total, u_hat share) of the split ``caps_votes`` -> ``routing``
    path, each tensor counted once: u and W read, u_hat written by K14a
    and read back by K14b, v written.  K14b requests u_hat once per
    routing pass; the passes after the first find it in L2."""
    u = batch * num_caps * caps_dim
    w = num_caps * jd * caps_dim
    v = batch * jd
    uhat = 2 * batch * num_caps * jd                 # write + read back
    return float((u + w + v + uhat) * ELEM_BYTES), float(uhat * ELEM_BYTES)


def squash_lanes(d: int) -> int:
    """Threads that share one row of ``d`` floats in the standalone squash
    (``csrc/squash.cu``): a lane per four floats, a power of two, at most
    a warp."""
    return min(WARP, 1 << (-(-d // 4) - 1).bit_length())


def squash_grid(rows: int, block_rows: int,
                lanes: int) -> tuple[int, int]:
    """(CTAs, threads a CTA) of the standalone squash: ``block_rows`` rows
    a CTA of ``block_rows * lanes`` threads, rounded up to a warp, up to
    ``CTA_THREADS`` (the CTA then takes its rows in passes)."""
    return (-(-rows // block_rows),
            min(CTA_THREADS, -(-block_rows * lanes // WARP) * WARP))


def squash_block_rows(d: int, rows: int) -> int:
    """Rows one standalone-squash CTA takes for ``rows`` capsules of ``d``
    floats: the most whole warps of rows, up to ``CTA_THREADS`` threads,
    whose grid still gives every SM a CTA; one warp's rows where even
    that grid is smaller than the card; never more than ``rows``."""
    per_warp = WARP // squash_lanes(d)
    for warps in (8, 4, 2, 1):
        if -(-rows // (warps * per_warp)) >= NUM_SMS:
            return warps * per_warp
    return max(1, min(per_warp, rows))


def routing_bwd_cluster_smem(mode: str, num_caps: int, block_i: int,
                             caps_dim: int, j: int, jd: int,
                             cluster: int) -> int:
    """Shared memory of one CTA of K9's cluster replay
    (``csrc/votes_routing_bwd.cu``): the votes rows of its ``ceil(I /
    cluster)`` rows (all when resident, ``block_i`` when streamed) with
    their couplings, the rows' u and logits, and seven [J*D] vectors (s,
    v, s_{T-1}, ds_T, dv and the two partials)."""
    rows = -(-num_caps // cluster)
    vrows = rows if mode == "resident" else min(block_i, rows)
    return (vrows * (jd + 1 + j) + rows * (caps_dim + j)
            + 7 * jd) * ELEM_BYTES


def routing_bwd_emit_smem(caps_dim: int, j: int, jd: int) -> int:
    """Shared memory of one emit CTA (one capsule i): W[i] and the dW[i]
    accumulator, then per chunk of ``EMIT_CHUNK`` samples their u[i],
    couplings c_T / c_{T-1} and the d u_hat rows."""
    return (2 * jd * caps_dim
            + EMIT_CHUNK * (caps_dim + 2 * j + jd)) * ELEM_BYTES


def plan_routing_bwd_cluster(num_caps: int, caps_dim: int, jd: int, j: int,
                             *, iters: int = 3, batch: int = 1,
                             smem_budget: int = SMEM_BYTES,
                             cluster: int | None = None,
                             votes: str | None = None
                             ) -> VotesRoutingSchedule | None:
    """K9's cluster schedule: for each cluster size (only ``cluster`` when
    given), resident votes in each CTA where they fit, else streamed at
    the largest i-tile that fits (next to the emit CTA's footprint; only
    the placement ``votes`` when given); of those, the least
    ``cluster_seconds`` at ``batch``, the smaller cluster on a tie.  None
    where no size fits."""
    emit = routing_bwd_emit_smem(caps_dim, j, jd)
    placements = tuple((m, n) for m, n in (("resident", 1),
                                           ("streamed", iters + 2))
                       if votes in (None, m))
    best = None
    for cs in (CLUSTER_SIZES if cluster is None else (cluster,)):
        rows = -(-num_caps // cs)
        for mode, n_passes in placements:
            def smem_of(bi, mode=mode, cs=cs):
                need = max(routing_bwd_cluster_smem(
                    mode, num_caps, bi, caps_dim, j, jd, cs), emit)
                return need if need <= smem_budget else None
            fit = _largest_fit(rows, smem_of)
            if fit is None:
                continue
            flops, w_bytes = routing_work(num_caps, caps_dim, jd, n_passes,
                                          iters + 2)
            per_sm = ctas_per_sm(fit[1], ROUTING_CLUSTER_REGISTERS)
            t = cluster_seconds(batch, cs, flops, w_bytes, iters + 2, rows,
                                per_sm)
            if best is None or t < best[0]:
                best = (t, VotesRoutingSchedule(
                    mode=mode, block_i=fit[0], smem_bytes=fit[1],
                    n_passes=n_passes,
                    cluster=cluster_plan(batch, cs, rows, per_sm),
                    seconds=t))
            break
    return best[1] if best else None


def plan_votes_routing_bwd(num_caps: int, caps_dim: int, jd: int, j: int,
                           *, iters: int = 3, batch: int = 1,
                           smem_budget: int = SMEM_BYTES,
                           name: str = FUSED_NAME) -> VotesRoutingSchedule:
    """Schedule of the routing BACKWARD, made on its own footprint: the
    replay on a cluster (``plan_routing_bwd_cluster``), each CTA's rows'
    votes resident where they fit (K8) and streamed otherwise (K9).
    ``n_passes`` counts votes computations per sample: 1 with resident
    votes, ``iters + 2`` streamed (``iters + 1`` replay passes, then one
    merged seed+reverse pass).  Raises ``PlanError`` naming the ``-bwd``
    op when nothing fits."""
    emit = routing_bwd_emit_smem(caps_dim, j, jd)
    sched = plan_routing_bwd_cluster(num_caps, caps_dim, jd, j, iters=iters,
                                     batch=batch, smem_budget=smem_budget)
    if sched is not None:
        return sched
    need = max(routing_bwd_cluster_smem(
        "streamed", num_caps, 1, caps_dim, j, jd, CLUSTER_SIZES[-1]), emit)
    raise PlanError(
        f"{name}{BWD_SUFFIX}: no feasible backward schedule: even a "
        f"{CLUSTER_SIZES[-1]}-CTA cluster streaming block_i=1 needs {need} "
        f"B of shared memory per CTA (with the emit's {emit} B), over the "
        f"{smem_budget} B budget ({num_caps} capsules of {caps_dim}D -> "
        f"{jd})")


def votes_routing_bwd_global_bytes(batch: int, num_caps: int, caps_dim: int,
                                   jd: int, j: int, n_passes: int) -> float:
    """Bytes the routing backward requests from global memory per step.
    Replay, per sample: u once, W ``n_passes`` times, the cotangent, and
    the logits ``b_{T-1}``, ``b_T`` plus ``ds_{T-1}``, ``ds_T`` written
    (each cluster CTA keeps its rows' logits on chip).  Emit: those read
    back with u and W once, du and dW written.  No u_hat or d u_hat term:
    neither reaches device memory."""
    u = num_caps * caps_dim
    w = num_caps * jd * caps_dim
    state = 2 * num_caps * j + 2 * jd
    replay = batch * (u + n_passes * w + jd + state)
    emit = batch * (state + 2 * u) + 2 * w
    return float((replay + emit) * ELEM_BYTES)


@dataclasses.dataclass(frozen=True)
class PrimaryRoutingSchedule:
    mode: str
    block_i: int
    block_k: int
    smem_bytes: int
    n_passes: int
    cluster: ClusterPlan
    seconds: float           # cluster_seconds of the schedule


def pipe_rows(p_pos: int) -> int:
    """Rows of the P x N tile each producer thread holds: the smallest
    built count with 4 x rows >= P."""
    return next(tr for tr in PIPE_ROWS_BUILT if 4 * tr >= p_pos)


def primary_routing_smem(mode: str, p_pos: int, n_ch: int, block_i: int,
                         caps_dim: int, j: int, jd: int,
                         cluster: int) -> int:
    """Shared memory of one ``primary_routing`` cluster CTA
    (``csrc/primary_routing.cu``'s layout): u of its rows (its ``p_pos x
    n_ch / cluster`` slice of the output), their logits, and s, v and two
    partials of s stay for the whole kernel; the producer's ring of patch
    and W_pc stages (``PIPE_BLOCK_K`` deep, patch rows padded by 4 floats;
    see ``PIPE_RING_FLOATS``), then its P x N partial tile, share one
    region with the consumer's votes rows and couplings, which only exist
    after the partials are summed."""
    rows = p_pos * (n_ch // cluster) // caps_dim
    vrows = rows if mode == "resident" else min(block_i, rows)
    stage = (4 * pipe_rows(p_pos) * (PIPE_BLOCK_K + 4)
             + PIPE_BLOCK_K * n_ch)
    consume = vrows * (jd + 1 + j)
    stages = max(PIPE_MIN_STAGES, min(PIPE_MAX_STAGES,
                                      max(consume, PIPE_RING_FLOATS) // stage))
    floats = (max(stages * stage, p_pos * n_ch, consume) + rows * caps_dim
              + rows * j + 4 * jd)
    return floats * ELEM_BYTES


def pipe_cluster_sizes(p_pos: int, n_ch: int, caps_dim: int) -> list[int]:
    """The cluster sizes K5 can run: each divides the capsule groups, and
    each CTA's channel slice is a multiple of 4."""
    groups = n_ch // caps_dim
    return [cs for cs in CLUSTER_SIZES
            if groups % cs == 0 and (n_ch // cs) % 4 == 0]


def plan_primary_routing(p_pos: int, k_in: int, n_ch: int, num_caps: int,
                         caps_dim: int, jd: int, j: int, *, iters: int = 3,
                         batch: int = 1, smem_budget: int = SMEM_BYTES,
                         cluster: int | None = None
                         ) -> PrimaryRoutingSchedule:
    """Schedule of the pipelined PrimaryCaps -> routing kernel: for each
    cluster size (``pipe_cluster_sizes``; only ``cluster`` when given),
    resident votes in each CTA where they fit, else streamed at the
    largest i-tile that fits; of those, the least ``cluster_seconds`` at
    ``batch`` (the producer's K split over the cluster, two barriers of
    its own), the smaller cluster on a tie.  Raises ``PlanError`` when the
    producer's slice exceeds the kernel's limits or nothing fits --
    ``compile_plan`` then keeps the per-op pair."""
    if p_pos > PIPE_MAX_POSITIONS or n_ch > PIPE_MAX_CHANNELS \
            or n_ch % caps_dim or p_pos * (n_ch // caps_dim) != num_caps:
        raise PlanError(
            f"{PIPE_NAME}: the producer's {p_pos} positions x {n_ch} "
            f"channels exceed the kernel's {PIPE_MAX_POSITIONS} x "
            f"{PIPE_MAX_CHANNELS} tile (or are not {num_caps} whole "
            f"capsules)")
    sizes = pipe_cluster_sizes(p_pos, n_ch, caps_dim)
    if cluster is not None:
        sizes = [cs for cs in sizes if cs == cluster]
    best = None
    for cs in sizes:
        rows = num_caps // cs
        for mode, n_passes in (("resident", 1), ("streamed", iters + 1)):
            def smem_of(bi, mode=mode, cs=cs):
                need = primary_routing_smem(mode, p_pos, n_ch, bi, caps_dim,
                                            j, jd, cs)
                return need if need <= smem_budget else None
            fit = _largest_fit(rows, smem_of)
            if fit is None:
                continue
            flops, w_bytes = routing_work(num_caps, caps_dim, jd, n_passes,
                                          iters + 1)
            per_sm = ctas_per_sm(fit[1], PIPE_REGISTERS)
            t = cluster_seconds(
                batch, cs, flops + 2.0 * p_pos * k_in * n_ch,
                w_bytes + (p_pos + n_ch) * k_in * ELEM_BYTES, iters + 3,
                rows, per_sm)
            if best is None or t < best[0]:
                best = (t, PrimaryRoutingSchedule(
                    mode=mode, block_i=fit[0], block_k=PIPE_BLOCK_K,
                    smem_bytes=fit[1], n_passes=n_passes,
                    cluster=cluster_plan(batch, cs, rows, per_sm),
                    seconds=t))
            break
    if best is None:
        raise PlanError(
            f"{PIPE_NAME}: no feasible pipelined schedule within the "
            f"{smem_budget} B shared-memory budget at cluster sizes "
            f"{sizes}")
    return best[1]


# ---------------------------------------------------------------------------
# Compilation
# ---------------------------------------------------------------------------

def _conv_op(name: str, wl: MatmulWorkload, in_elems: int,
             smem_budget: int, squash_dim: int | None) -> OpPlan:
    """One conv op.  With ``squash_dim`` (PrimaryCaps) the squash fuses
    into the GEMM epilogue when a capsule-aligned tile fits; otherwise
    the op is the plain GEMM and the standalone squash (K10) follows it,
    as the reference's plan does."""
    block = None
    if squash_dim is not None:
        try:
            block = plan_matmul(wl, smem_budget, n_multiple=squash_dim,
                                stage_output=True)
        except ValueError:
            pass                       # no capsule-aligned tile: K10
    fused = block is not None
    if block is None:
        try:
            block = plan_matmul(wl, smem_budget)
        except ValueError as err:
            raise PlanError(f"{name}: no feasible GEMM tiling: {err}") \
                from None
    # image read + patch write by the extraction, then the GEMM.
    nbytes = in_elems * ELEM_BYTES + wl.m * wl.k * ELEM_BYTES \
        + block.hbm_bytes
    block_rows = None
    if squash_dim is not None:
        rows = wl.m * wl.n // squash_dim
        block_rows = squash_block_rows(squash_dim, rows)
        if not fused:                  # K10 reads and writes u once
            nbytes += 2 * wl.m * wl.n * ELEM_BYTES
    return OpPlan(
        name=name,
        kernel="conv_im2col+squash" if fused else "conv_im2col",
        block=block, smem_bytes=block.smem_bytes, global_bytes=nbytes,
        block_rows=block_rows)


def _conv_bwd_op(fwd: OpPlan, wl: MatmulWorkload, in_elems: int,
                 smem_budget: int, needs_dx: bool) -> OpPlan:
    """Backward of one conv: K1 recompute, the pre-activation recompute
    on the forward tiles (fused squash only), K6 for dW, and -- unless
    the input is the image, which asks for no gradient -- the dpatches
    GEMM on its own tiles and K7."""
    try:
        dx_block = plan_matmul(MatmulWorkload(m=wl.m, k=wl.n, n=wl.k),
                               smem_budget)
    except ValueError as err:
        raise PlanError(f"{fwd.name}{BWD_SUFFIX}: no feasible dpatches "
                        f"tiling: {err}") from None
    patches = wl.m * wl.k
    splits = at_b_plan(wl.m, wl.k, wl.n).splits
    elems = (in_elems + patches                           # K1 recompute
             + patches + wl.m * wl.n + wl.k * wl.n        # K6
             + (2 * splits * wl.k * wl.n if splits > 1 else 0))
    nbytes = elems * ELEM_BYTES
    if fwd.fuses_squash:
        nbytes += fwd.block.hbm_bytes
    if needs_dx:                                   # dpatches GEMM, then K7
        nbytes += dx_block.hbm_bytes + (patches + in_elems) * ELEM_BYTES
    return OpPlan(
        name=fwd.name + BWD_SUFFIX, kernel="conv_im2col_bwd",
        block=fwd.block, dx_block=dx_block,
        smem_bytes=max(fwd.block.smem_bytes, dx_block.smem_bytes,
                       AT_B_SMEM_BYTES),
        global_bytes=float(nbytes))


def compile_plan(cfg: CapsNetConfig = CapsNetConfig(), *, batch: int = 1,
                 smem_budget: int = SMEM_BYTES, pipeline: bool = False,
                 train: bool = False) -> ExecutionPlan:
    """Compile ``cfg`` into the per-operation ExecutionPlan (memoized:
    plans are immutable, and equal arguments give the same object however
    they are spelled).  ``pipeline=True`` replaces PrimaryCaps and the
    first routing layer with ONE ``primary_routing`` op when its schedule
    fits, and keeps the per-op pair otherwise.  ``train=True`` appends the
    backward ops (see the module note)."""
    return _compile_plan(cfg, batch, smem_budget, pipeline, train)


@functools.lru_cache(maxsize=64)         # keyed by value, not by spelling
def _compile_plan(cfg: CapsNetConfig, batch: int, smem_budget: int,
                  pipeline: bool, train: bool) -> ExecutionPlan:
    c1_hw, pc_hw = cfg.conv1_out, cfg.pc_out
    conv1 = _conv_op(
        "Conv1", MatmulWorkload(m=batch * c1_hw ** 2,
                                k=cfg.conv1_kernel ** 2 * cfg.in_channels,
                                n=cfg.conv1_channels),
        batch * cfg.image_hw ** 2 * cfg.in_channels, smem_budget, None)
    pc_wl = MatmulWorkload(m=batch * pc_hw ** 2,
                           k=cfg.pc_kernel ** 2 * cfg.conv1_channels,
                           n=cfg.pc_channels)
    pc_in = batch * c1_hw ** 2 * cfg.conv1_channels
    pc_op = _conv_op("PrimaryCaps", pc_wl, pc_in, smem_budget,
                     cfg.primary_dim)
    ops = [conv1, pc_op]
    stack = cfg.routing_stack()
    for lay in stack:
        sched = plan_votes_routing(lay.in_caps, lay.in_dim, lay.jd,
                                   lay.num_caps, iters=lay.iters, batch=batch,
                                   smem_budget=smem_budget, name=lay.name)
        ops.append(OpPlan(
            name=lay.name, kernel="votes_routing", block=sched.cluster,
            smem_bytes=sched.smem_bytes,
            global_bytes=votes_routing_global_bytes(
                batch, lay.in_caps, lay.in_dim, lay.jd, sched.n_passes,
                lay.num_caps if sched.mode == STREAMED_GLOBAL else 0),
            block_i=sched.block_i, mode=sched.mode,
            n_passes=sched.n_passes))

    first = stack[0]
    if pipeline and not first.residual:
        try:
            sched = plan_primary_routing(
                pc_hw ** 2, pc_wl.k, pc_wl.n, first.in_caps, first.in_dim,
                first.jd, first.num_caps, iters=first.iters, batch=batch,
                smem_budget=smem_budget)
        except PlanError:
            sched = None                 # the per-op pair is the fallback
        if sched is not None:
            patches = pc_wl.m * pc_wl.k
            w_pc = (pc_wl.k + 1) * pc_wl.n                # weights + bias
            w_cc = first.in_caps * first.jd * first.in_dim
            ops = [conv1, OpPlan(
                name=PIPE_NAME, kernel="primary_routing",
                block=sched.cluster, smem_bytes=sched.smem_bytes,
                # The extraction reads the image and writes the patches;
                # then each CTA of a sample's cluster reads its slab of the
                # sample's patches and of W_pc and its rows of W_cc once per
                # pass, and rank 0 writes v.
                global_bytes=float(ELEM_BYTES * (
                    pc_in + 2 * patches + batch * (
                        w_pc + sched.n_passes * w_cc + first.jd))),
                block_i=sched.block_i, block_k=sched.block_k,
                mode=sched.mode, n_passes=sched.n_passes)] + ops[3:]

    if train:
        for lay in reversed(stack):
            sched = plan_votes_routing_bwd(
                lay.in_caps, lay.in_dim, lay.jd, lay.num_caps,
                iters=lay.iters, batch=batch, smem_budget=smem_budget,
                name=lay.name)
            ops.append(OpPlan(
                name=lay.name + BWD_SUFFIX, kernel="votes_routing_bwd",
                block=sched.cluster, smem_bytes=sched.smem_bytes,
                global_bytes=votes_routing_bwd_global_bytes(
                    batch, lay.in_caps, lay.in_dim, lay.jd, lay.num_caps,
                    sched.n_passes),
                block_i=sched.block_i, mode=sched.mode,
                n_passes=sched.n_passes))
        ops.append(_conv_bwd_op(pc_op, pc_wl, pc_in, smem_budget, True))
        ops.append(_conv_bwd_op(
            conv1, MatmulWorkload(m=batch * c1_hw ** 2,
                                  k=cfg.conv1_kernel ** 2 * cfg.in_channels,
                                  n=cfg.conv1_channels),
            batch * cfg.image_hw ** 2 * cfg.in_channels, smem_budget,
            False))

    plan = ExecutionPlan(cfg=cfg, batch=batch, smem_budget=smem_budget,
                         ops=tuple(ops), train=train)
    plan.validate()
    return plan


compile_plan.cache_info = _compile_plan.cache_info


# ---------------------------------------------------------------------------
# Graceful degradation: replanning under a reduced shared-memory budget
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DegradeReport:
    """What ``degrade_plan`` gave up to fit the reduced budget.

    ``concessions`` is human-readable, one entry per rung taken relative
    to the full-budget plan: the pipelined pair dissolving to per-op, a
    layer going resident -> streamed (-> streamed-global), a shrunk
    ``block_i`` / ``block_k`` / conv tile, a changed cluster size.  Empty
    means the reduced budget still admits the full-budget schedule.
    ``batch`` always equals ``requested_batch``: on Hopper no footprint
    depends on the batch, so there is no batch rung."""

    smem_budget: int
    requested_batch: int
    batch: int
    concessions: tuple[str, ...]

    @property
    def degraded(self) -> bool:
        return bool(self.concessions)


def _plan_concessions(baseline: ExecutionPlan, plan: ExecutionPlan,
                      perop: ExecutionPlan | None = None
                      ) -> tuple[str, ...]:
    """Human-readable diff of what ``plan`` gave up against ``baseline``,
    in the reference's order.  Once the pipelined pair has dissolved, the
    ops that replace it are diffed against ``perop``, the full-budget
    per-op plan, which has them."""
    notes: list[str] = []
    base_ops = {}
    if baseline.pipelined and not plan.pipelined:
        notes.append(f"pipelined {PIPE_NAME} pair -> per-op "
                     f"(inter-layer u round-trips device memory again)")
        if perop is not None:
            base_ops.update((op.name, op) for op in perop.ops)
    base_ops.update((op.name, op) for op in baseline.ops)
    for op in plan.ops:
        base = base_ops.get(op.name)
        if base is None:
            continue
        if base.mode != op.mode and op.mode is not None:
            notes.append(f"{op.name}: {base.mode} -> {op.mode}")
        if (base.block_i is not None and op.block_i is not None
                and op.block_i < base.block_i):
            notes.append(f"{op.name}: block_i {base.block_i} "
                         f"-> {op.block_i}")
        if (base.block_k is not None and op.block_k is not None
                and op.block_k < base.block_k):
            notes.append(f"{op.name}: block_k {base.block_k} "
                         f"-> {op.block_k}")
        if isinstance(base.block, BlockPlan) \
                and isinstance(op.block, BlockPlan):
            was, now = (",".join(str(t) for t in (b.block_m, b.block_k,
                                                   b.block_n))
                        for b in (base.block, op.block))
            if now != was:
                notes.append(f"{op.name}: conv tiles ({was}) -> ({now})")
        if (base.cluster is not None and op.cluster is not None
                and op.cluster != base.cluster):
            notes.append(f"{op.name}: cluster {base.cluster} -> {op.cluster}")
    return tuple(notes)


def degrade_plan(cfg: CapsNetConfig = CapsNetConfig(),
                 smem_budget: int = SMEM_BYTES, *, batch: int = 1,
                 train: bool = False, pipeline: bool = False
                 ) -> tuple[ExecutionPlan, DegradeReport]:
    """Replan ``cfg`` under a (possibly reduced) ``smem_budget``, reporting
    what was given up relative to the full-budget plan.

    ``compile_plan`` already walks the ladder (pipelined pair -> per-op,
    resident -> streamed -> streamed-global over the cluster sizes,
    smaller GEMM tiles), so this recompiles at the reduced budget.  At the
    full budget the plan is the memoized ``compile_plan`` object itself,
    with no concessions.

    One designed difference from the reference: it has no batch rung.
    Every footprint here is one CTA's, and none grows with the batch, so
    a smaller batch never makes a plan fit, and the reference's
    ``min_batch`` has nothing to bound.  A budget with no plan raises the
    ``PlanError`` that names the budget and the op that did not fit
    (callers with a fixed slot batch treat it as "fall back to the plain
    backend")."""
    baseline = compile_plan(cfg, batch=batch, train=train, pipeline=pipeline)
    try:
        plan = compile_plan(cfg, batch=batch, smem_budget=smem_budget,
                            train=train, pipeline=pipeline)
    except PlanError as err:
        raise PlanError(
            f"degrade_plan: no feasible plan for batch {batch} under the "
            f"degraded {smem_budget} B shared-memory budget: {err}"
            ) from None
    perop = (compile_plan(cfg, batch=batch, train=train, pipeline=False)
             if baseline.pipelined and not plan.pipelined else None)
    return plan, DegradeReport(
        smem_budget=smem_budget, requested_batch=batch, batch=batch,
        concessions=_plan_concessions(baseline, plan, perop))

