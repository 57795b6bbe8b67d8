"""ExecutionPlan for Hopper: one compiled schedule the kernels execute.

The forward half of ``repro/core/execplan.py``, derived again for an
H100.  ``compile_plan`` turns a ``CapsNetConfig`` into one ``OpPlan`` per
executed kernel call, with the reference's op names:

  Conv1, PrimaryCaps   ``conv_im2col``: patch extraction (K1) + the tiled
                       GEMM (K2) over ``planner.plan_matmul``'s tiles.
                       PrimaryCaps always fuses the capsule squash into
                       the GEMM epilogue: its tile width is a multiple of
                       the capsule size, so the standalone squash kernel
                       (K10) stays off this path.
  ClassCaps-Routing    ``votes_routing`` (K3/K4): votes + every routing
                       iteration, one CTA per sample.
  PrimaryCaps-Routing  ``primary_routing`` (K5, ``pipeline=True``):
                       PrimaryCaps + the first routing layer in one
                       kernel, u kept in shared memory.

The budget is the shared memory of one CTA (``planner.SMEM_BYTES``), not
the TPU's VMEM.  The routing kernels run one CTA per sample, so their
footprints do not grow with the batch; a schedule that fits, fits at
every batch.  ``resident`` keeps one sample's whole votes tensor in
shared memory and computes it once; ``streamed`` keeps u and the logits
and recomputes the votes from W on each of the ``iters + 1`` passes.
At MNIST width one sample's votes (1152 x 160 fp32 = 737,280 B) do not
fit, so the plan picks ``streamed``; splitting i over a thread-block
cluster so that ``resident`` fits is later work.
"""

from __future__ import annotations

import dataclasses
import functools

from repro_torch.core.capsnet import ROUTING_NAME, CapsNetConfig
from repro_torch.core.planner import (ELEM_BYTES, SMEM_BYTES, BlockPlan,
                                      MatmulWorkload, plan_matmul)

FUSED_NAME = ROUTING_NAME
PIPE_NAME = "PrimaryCaps-Routing"
MODES = ("resident", "streamed")

# Limits of primary_routing's produce phase (csrc/primary_routing.cu):
# each of its 256 threads accumulates up to 16 output rows x 4 columns.
PIPE_MAX_POSITIONS = 64
PIPE_MAX_CHANNELS = 256
BLOCK_I_CANDIDATES = (256, 128, 64, 32, 16, 8, 4, 2, 1)
PIPE_BLOCK_K_CANDIDATES = (32, 16, 8)


class PlanError(ValueError):
    """An ExecutionPlan cannot be built or violates one of its invariants."""


@dataclasses.dataclass(frozen=True)
class OpPlan:
    """The compiled schedule of one kernel call.

    ``block`` holds the GEMM tiles of the conv ops and of the pipelined
    op's producer; ``block_i`` / ``mode`` / ``n_passes`` the routing
    schedule (W is read ``n_passes`` times per sample); ``block_k`` the
    pipelined producer's K tile.  ``smem_bytes`` is the modeled shared
    memory of one CTA, and ``global_bytes`` the bytes the op requests
    from global memory per forward at the plan batch (served by L2 where
    a re-read operand fits there).
    """

    name: str
    kernel: str
    block: BlockPlan | None
    smem_bytes: int
    global_bytes: float
    block_i: int | None = None
    mode: str | None = None
    n_passes: int | None = None
    block_k: int | None = None

    @property
    def fuses_squash(self) -> bool:
        """Whether this op's epilogue absorbs the squash activation."""
        return self.kernel.endswith("+squash")


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    cfg: CapsNetConfig
    batch: int
    smem_budget: int
    ops: tuple[OpPlan, ...]

    def op(self, name: str) -> OpPlan:
        for op in self.ops:
            if op.name == name:
                return op
        raise KeyError(f"no operation {name!r} in plan "
                       f"({[o.name for o in self.ops]})")

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
        if names != expected:
            raise PlanError(f"plan ops {names}, expected {expected}")
        for op in self.ops:
            if op.mode is not None and op.mode not in MODES:
                raise PlanError(f"{op.name}: unknown mode {op.mode!r}")
            if op.smem_bytes > self.smem_budget:
                raise PlanError(
                    f"{op.name}: shared-memory footprint {op.smem_bytes} B "
                    f"exceeds the {self.smem_budget} B budget")

    def summary(self) -> list[dict]:
        return [dict(name=op.name, kernel=op.kernel,
                     block=((op.block.block_m, op.block.block_k,
                             op.block.block_n) if op.block else None),
                     block_i=op.block_i, block_k=op.block_k, mode=op.mode,
                     n_passes=op.n_passes, smem_kib=op.smem_bytes / 1024,
                     global_bytes=op.global_bytes)
                for op in self.ops]


# ---------------------------------------------------------------------------
# Routing schedules (votes_routing and the consume phase of primary_routing)
# ---------------------------------------------------------------------------

def routing_smem_floats(mode: str, num_caps: int, block_i: int, j: int,
                        jd: int) -> int:
    """Votes + routing scratch of one CTA beyond u, in floats: the logits
    ``[I, J]``, s and v ``[J*D]``, and the votes rows with their
    couplings -- all I rows when resident, ``block_i`` rows when
    streamed.  Votes rows are padded to ``J*D + 1`` floats so that the
    per-row logits update reads shared memory without bank conflicts."""
    rows = num_caps if mode == "resident" else block_i
    return num_caps * j + 2 * jd + rows * (jd + 1 + j)


def votes_routing_smem(mode: str, num_caps: int, block_i: int, caps_dim: int,
                       j: int, jd: int) -> int:
    """Shared memory of one ``votes_routing`` CTA: u of its sample plus
    the routing scratch."""
    return (num_caps * caps_dim
            + routing_smem_floats(mode, num_caps, block_i, j, jd)) * ELEM_BYTES


@dataclasses.dataclass(frozen=True)
class VotesRoutingSchedule:
    mode: str
    block_i: int
    smem_bytes: int
    n_passes: int            # W reads per sample: 1 resident, iters+1 str.


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
                       iters: int = 3, smem_budget: int = SMEM_BYTES,
                       name: str = FUSED_NAME) -> VotesRoutingSchedule:
    """Resident-vs-streamed decision for ``votes_routing``: resident when
    one sample's votes fit a CTA, else streamed at the largest i-tile
    that fits.  Raises ``PlanError`` naming the op when even streamed
    ``block_i=1`` does not fit."""
    def fits(mode):
        def smem_of(bi):
            need = votes_routing_smem(mode, num_caps, bi, caps_dim, j, jd)
            return need if need <= smem_budget else None
        return smem_of

    for mode, n_passes in (("resident", 1), ("streamed", iters + 1)):
        fit = _largest_fit(num_caps, fits(mode))
        if fit is not None:
            return VotesRoutingSchedule(mode=mode, block_i=fit[0],
                                        smem_bytes=fit[1], n_passes=n_passes)
    need = votes_routing_smem("streamed", num_caps, 1, caps_dim, j, jd)
    raise PlanError(
        f"{name}: no feasible schedule: even streamed block_i=1 needs "
        f"{need} B of shared memory per CTA, over the {smem_budget} B "
        f"budget ({num_caps} capsules of {caps_dim}D -> {jd})")


def votes_routing_global_bytes(batch: int, num_caps: int, caps_dim: int,
                               jd: int, n_passes: int) -> float:
    """u read once, W read ``n_passes`` times per sample, v written once."""
    per_sample = (num_caps * caps_dim + n_passes * num_caps * jd * caps_dim
                  + jd)
    return float(batch * per_sample * ELEM_BYTES)


@dataclasses.dataclass(frozen=True)
class PrimaryRoutingSchedule:
    mode: str
    block_i: int
    block_k: int
    smem_bytes: int
    n_passes: int


def primary_routing_smem(mode: str, p_pos: int, n_ch: int, block_k: int,
                         num_caps: int, block_i: int, caps_dim: int, j: int,
                         jd: int) -> int:
    """Shared memory of one ``primary_routing`` CTA: u (the producer's
    output, ``P x N`` = ``I x C`` floats) and the logits and s/v stay for
    the whole kernel; the producer's patch and W_pc K-tiles share one
    region with the consumer's votes rows and couplings, which only
    exist after the producer is done."""
    produce = p_pos * block_k + block_k * n_ch
    rows = num_caps if mode == "resident" else block_i
    consume = rows * (jd + 1 + j)
    floats = (num_caps * caps_dim + num_caps * j + 2 * jd
              + max(produce, consume))
    return floats * ELEM_BYTES


def plan_primary_routing(p_pos: int, k_in: int, n_ch: int, num_caps: int,
                         caps_dim: int, jd: int, j: int, *, iters: int = 3,
                         smem_budget: int = SMEM_BYTES
                         ) -> PrimaryRoutingSchedule:
    """Schedule for the pipelined PrimaryCaps -> routing kernel: resident
    consume if it fits, else streamed; the largest produce K-tile and
    i-tile that fit.  Raises ``PlanError`` when the producer exceeds the
    kernel's per-thread accumulators or nothing fits -- ``compile_plan``
    then keeps the per-op pair."""
    if p_pos > PIPE_MAX_POSITIONS or n_ch > PIPE_MAX_CHANNELS:
        raise PlanError(
            f"{PIPE_NAME}: the producer's {p_pos} positions x {n_ch} "
            f"channels exceed the kernel's {PIPE_MAX_POSITIONS} x "
            f"{PIPE_MAX_CHANNELS} accumulators")
    for mode, n_passes in (("resident", 1), ("streamed", iters + 1)):
        for bk in PIPE_BLOCK_K_CANDIDATES:
            bk = min(bk, k_in)
            def smem_of(bi, mode=mode, bk=bk):
                need = primary_routing_smem(mode, p_pos, n_ch, bk, num_caps,
                                            bi, caps_dim, j, jd)
                return need if need <= smem_budget else None
            fit = _largest_fit(num_caps, smem_of)
            if fit is not None:
                return PrimaryRoutingSchedule(
                    mode=mode, block_i=fit[0], block_k=bk,
                    smem_bytes=fit[1], n_passes=n_passes)
    raise PlanError(
        f"{PIPE_NAME}: no feasible pipelined schedule within the "
        f"{smem_budget} B shared-memory budget")


# ---------------------------------------------------------------------------
# Compilation
# ---------------------------------------------------------------------------

def _conv_op(name: str, wl: MatmulWorkload, in_elems: int,
             smem_budget: int, squash_dim: int | None) -> OpPlan:
    try:
        block = plan_matmul(wl, smem_budget, n_multiple=squash_dim or 1,
                            stage_output=squash_dim is not None)
    except ValueError as err:
        hint = (" (the squash cannot fuse into the epilogue, and the "
                "standalone squash kernel K10 is not ported yet: ROADMAP "
                "queue 2)" if squash_dim is not None else "")
        raise PlanError(f"{name}: no feasible GEMM tiling: {err}{hint}") \
            from None
    patches = wl.m * wl.k * ELEM_BYTES
    return OpPlan(
        name=name,
        kernel="conv_im2col+squash" if squash_dim else "conv_im2col",
        block=block, smem_bytes=block.smem_bytes,
        # image read + patch write by the extraction, then the GEMM.
        global_bytes=in_elems * ELEM_BYTES + patches + block.hbm_bytes)


@functools.lru_cache(maxsize=64)
def compile_plan(cfg: CapsNetConfig = CapsNetConfig(), *, batch: int = 1,
                 smem_budget: int = SMEM_BYTES,
                 pipeline: bool = False) -> ExecutionPlan:
    """Compile ``cfg`` into the per-operation ExecutionPlan (memoized:
    plans are immutable).  ``pipeline=True`` replaces PrimaryCaps and the
    first routing layer with ONE ``primary_routing`` op when its schedule
    fits, and keeps the per-op pair otherwise."""
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
    ops = [conv1, _conv_op("PrimaryCaps", pc_wl, pc_in, smem_budget,
                           cfg.primary_dim)]
    stack = cfg.routing_stack()
    for lay in stack:
        sched = plan_votes_routing(lay.in_caps, lay.in_dim, lay.jd,
                                   lay.num_caps, iters=lay.iters,
                                   smem_budget=smem_budget, name=lay.name)
        ops.append(OpPlan(
            name=lay.name, kernel="votes_routing", block=None,
            smem_bytes=sched.smem_bytes,
            global_bytes=votes_routing_global_bytes(
                batch, lay.in_caps, lay.in_dim, lay.jd, sched.n_passes),
            block_i=sched.block_i, mode=sched.mode,
            n_passes=sched.n_passes))

    first = stack[0]
    if pipeline and not first.residual:
        try:
            sched = plan_primary_routing(
                pc_hw ** 2, pc_wl.k, pc_wl.n, first.in_caps, first.in_dim,
                first.jd, first.num_caps, iters=first.iters,
                smem_budget=smem_budget)
        except PlanError:
            sched = None                 # the per-op pair is the fallback
        if sched is not None:
            patches = pc_wl.m * pc_wl.k
            w_pc = (pc_wl.k + 1) * pc_wl.n                # weights + bias
            w_cc = first.in_caps * first.jd * first.in_dim
            ops = [conv1, OpPlan(
                name=PIPE_NAME, kernel="primary_routing", block=None,
                smem_bytes=sched.smem_bytes,
                # The extraction reads the image and writes the patches;
                # then each CTA reads its sample's patches, all of W_pc
                # and W_cc once per pass, and writes v.
                global_bytes=float(ELEM_BYTES * (
                    pc_in + 2 * patches + batch * (
                        w_pc + sched.n_passes * w_cc + first.jd))),
                block_i=sched.block_i, block_k=sched.block_k,
                mode=sched.mode, n_passes=sched.n_passes)] + ops[3:]

    plan = ExecutionPlan(cfg=cfg, batch=batch, smem_budget=smem_budget,
                         ops=tuple(ops))
    plan.validate()
    return plan
