"""CapsAcc dataflow model: per-operation memory requirements and accesses.

The counterpart of ``repro/core/analysis.py``, the same model: it reads
only the network's shape, so the port's ``ExecutionPlan`` (and the DSE,
energy and PMU models over it) score the paper's accelerator exactly as
the reference does.

Reproduces the structure of CapStore Fig. 4: for every operation of the
CapsuleNet (Sabour et al. 2017) MNIST inference on a 16x16 systolic array we
derive

  * cycles                       (Fig. 4b)
  * on-chip size per component   (Fig. 4a/4c: data / weight / accumulator)
  * reads+writes per component   (Fig. 4d/4e)
  * off-chip accesses            (paper Eq. (1)/(2))

The paper's exact byte values are figure-bound and not recoverable from the
text, so the numbers here are re-derived from first principles with the
following documented dataflow assumptions (chosen to be consistent with all
of the paper's qualitative statements):

  * activations/weights are 16-bit fixed point, accumulators 32-bit
    (CapsAcc uses 25-bit internal accumulation; we round up to 32);
  * convolutions run output-stationary over *all* output channels
    (partial sums for the whole dense output live in the accumulator
    memory, strided selection happens on write-back) -> accumulator is the
    largest component of every operation and PrimaryCaps is the peak op;
  * conv weights stream through a double-buffered 16x16 tile
    (weight reuse across output positions -> tiny weight memory);
  * ClassCaps weights have no reuse at all and stream through a larger
    prefetch buffer;
  * all routing state (u_hat, b, c, s, v) stays on-chip across the routing
    iterations: u_hat lives in the accumulator memory where CC-FC produced
    it, coupling coefficients play the role of "weights".

A matmul-view of each operation drives the access counts: an [M,K] x [K,N]
product on the 16x16 array reads each weight once (weight-stationary
streaming), re-reads each input element once per 16-wide output-column
group, and performs one accumulator read-modify-write per 16-deep K tile.

The model is parametric over the network shape (``CapsNetDims``) so an
``ExecutionPlan`` can be compiled for any ``CapsNetConfig``; the module
constants below are the paper's MNIST instance and remain the defaults.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

ARRAY_DIM = 16          # 16x16 processing elements
ACT_BYTES = 2           # 16-bit activations / weights
ACC_BYTES = 4           # 32-bit partial sums

# CapsuleNet (MNIST) shape constants [Sabour et al. 2017]
IN_H = IN_W = 28
CONV1_K, CONV1_CIN, CONV1_COUT = 9, 1, 256
CONV1_OUT = 20                           # 28 - 9 + 1
PC_K, PC_CIN, PC_COUT, PC_STRIDE = 9, 256, 256, 2
PC_OUT = 6                               # floor((20 - 9)/2) + 1
NUM_PRIMARY = PC_OUT * PC_OUT * 32       # 1152 capsules
PRIMARY_DIM = 8
NUM_CLASSES = 10
CLASS_DIM = 16
ROUTING_ITERS = 3


@dataclasses.dataclass(frozen=True)
class CapsNetDims:
    """Shape of one CapsuleNet instance, as the dataflow model sees it.

    Defaults are the paper's MNIST network; ``dims_from_config`` derives an
    instance from a ``repro_torch.core.capsnet.CapsNetConfig``.
    """

    in_hw: int = IN_H
    conv1_k: int = CONV1_K
    conv1_cin: int = CONV1_CIN
    conv1_cout: int = CONV1_COUT
    pc_k: int = PC_K
    pc_stride: int = PC_STRIDE
    pc_cout: int = PC_COUT
    num_primary_groups: int = 32
    primary_dim: int = PRIMARY_DIM
    num_classes: int = NUM_CLASSES
    class_dim: int = CLASS_DIM
    routing_iters: int = ROUTING_ITERS

    @property
    def conv1_out(self) -> int:
        return self.in_hw - self.conv1_k + 1

    @property
    def pc_cin(self) -> int:
        return self.conv1_cout

    @property
    def pc_out(self) -> int:
        return (self.conv1_out - self.pc_k) // self.pc_stride + 1

    @property
    def num_primary(self) -> int:
        return self.pc_out * self.pc_out * self.num_primary_groups


MNIST_DIMS = CapsNetDims()


@dataclasses.dataclass(frozen=True)
class RoutingLayerDims:
    """Duck-typed dims view of ONE routing layer of a deep capsule stack.

    The three routing profile builders (``classcaps_fc_profile``,
    ``sum_squash_profile``, ``update_sum_profile``) only read these five
    fields, so any layer of a ``caps_layers`` chain -- including the
    coupling halves of a ResCapsBlock -- profiles through the SAME
    builders the paper's single ClassCaps layer uses: ``num_primary`` is
    the layer's in-capsule count, ``num_classes``/``class_dim`` its
    output capsules.
    """

    num_primary: int
    primary_dim: int
    num_classes: int
    class_dim: int
    routing_iters: int


def dims_from_config(cfg) -> CapsNetDims:
    """Derive the dataflow dims from a ``CapsNetConfig`` (duck-typed)."""
    return CapsNetDims(
        in_hw=cfg.image_hw,
        conv1_k=cfg.conv1_kernel,
        conv1_cin=cfg.in_channels,
        conv1_cout=cfg.conv1_channels,
        pc_k=cfg.pc_kernel,
        pc_stride=cfg.pc_stride,
        pc_cout=cfg.pc_channels,
        num_primary_groups=cfg.num_primary_groups,
        primary_dim=cfg.primary_dim,
        num_classes=cfg.num_classes,
        class_dim=cfg.class_dim,
        routing_iters=cfg.routing_iters,
    )


@dataclasses.dataclass(frozen=True)
class OperationProfile:
    """Resource profile of one CapsuleNet inference operation."""

    name: str
    macs: float
    cycles: float
    # on-chip requirement (bytes) per component
    data_mem: float
    weight_mem: float
    accum_mem: float
    # on-chip accesses (element granularity)
    data_reads: float
    data_writes: float
    weight_reads: float
    weight_writes: float
    accum_reads: float
    accum_writes: float
    # off-chip accesses
    offchip_reads: float = 0.0
    offchip_writes: float = 0.0
    repeats: int = 1  # routing ops execute once per routing iteration

    @property
    def total_mem(self) -> float:
        return self.data_mem + self.weight_mem + self.accum_mem

    @property
    def total_cycles(self) -> float:
        return self.cycles * self.repeats

    def component(self, name: str) -> float:
        return {"data": self.data_mem, "weight": self.weight_mem,
                "accum": self.accum_mem}[name]

    def accesses(self, name: str) -> float:
        r = {"data": self.data_reads, "weight": self.weight_reads,
             "accum": self.accum_reads}[name]
        w = {"data": self.data_writes, "weight": self.weight_writes,
             "accum": self.accum_writes}[name]
        return (r + w) * self.repeats


def _tiles(n: int, t: int = ARRAY_DIM) -> int:
    return math.ceil(n / t)


def _matmul_accesses(m: int, k: int, n: int) -> dict:
    """Access counts for [M,K]x[K,N] on the 16x16 weight-stationary array."""
    kt = _tiles(k)
    nt = _tiles(n)
    return dict(
        weight_reads=float(k * n),                 # each weight read once
        data_reads=float(m * k * nt),              # re-stream per col-group
        accum_writes=float(m * n * kt),            # partial per K tile
        accum_reads=float(m * n * max(kt - 1, 0)),  # read-modify-write
        cycles=float(_tiles(m) * k * nt),
        macs=float(m) * k * n,
    )


# ---------------------------------------------------------------------------
# Per-operation profiles
# ---------------------------------------------------------------------------

def conv1_profile(dims: CapsNetDims = MNIST_DIMS) -> OperationProfile:
    m = dims.conv1_out * dims.conv1_out        # output positions
    k = dims.conv1_k * dims.conv1_k * dims.conv1_cin
    n = dims.conv1_cout
    a = _matmul_accesses(m, k, n)
    in_elems = dims.in_hw * dims.in_hw * dims.conv1_cin
    w_elems = k * n
    return OperationProfile(
        name="Conv1",
        macs=a["macs"],
        cycles=a["cycles"],
        data_mem=in_elems * ACT_BYTES,                       # full (tiny) input
        weight_mem=2 * k * ARRAY_DIM * ACT_BYTES,
        accum_mem=m * n * ACC_BYTES,                         # dense output @32b
        data_reads=a["data_reads"],
        data_writes=float(in_elems),
        weight_reads=a["weight_reads"],
        weight_writes=float(w_elems),
        accum_reads=a["accum_reads"],
        accum_writes=a["accum_writes"] + m * n,              # final writeback
    )


def primarycaps_profile(dims: CapsNetDims = MNIST_DIMS) -> OperationProfile:
    # Dense conv over the conv1 grid; strided selection on write-back.
    m = dims.pc_out * dims.pc_out                             # kept positions
    k = dims.pc_k * dims.pc_k * dims.pc_cin
    n = dims.pc_cout
    a = _matmul_accesses(m, k, n)
    in_elems = dims.conv1_out * dims.conv1_out * dims.pc_cin
    w_elems = k * n                                           # streamed
    return OperationProfile(
        name="PrimaryCaps",
        macs=a["macs"],
        cycles=a["cycles"],
        data_mem=in_elems * ACT_BYTES,                        # full input fmap
        weight_mem=2 * ARRAY_DIM * ARRAY_DIM * ACT_BYTES,     # streaming tile
        accum_mem=dims.conv1_out * dims.conv1_out * n * ACC_BYTES,
        data_reads=a["data_reads"],
        data_writes=float(in_elems),
        weight_reads=a["weight_reads"],
        weight_writes=float(w_elems),
        accum_reads=a["accum_reads"],
        accum_writes=a["accum_writes"] + m * n,
        # PrimaryCaps peak: full input residency + dense accumulation makes
        # this the largest-footprint operation (paper Fig. 4a).
    )


def classcaps_fc_profile(dims: CapsNetDims = MNIST_DIMS) -> OperationProfile:
    # Votes u_hat[i, j, d] = sum_c W[i, j, d, c] * u[i, c]
    m = dims.num_primary                     # input capsules
    k = dims.primary_dim
    n = dims.num_classes * dims.class_dim    # outputs per capsule
    a = _matmul_accesses(m, k, n)
    u_elems = m * k
    w_elems = m * k * n            # weights unique per (i, j): no reuse
    votes = m * n
    stream_group = 16              # i-capsules prefetched per group
    return OperationProfile(
        name="ClassCaps-FC",
        macs=a["macs"],
        cycles=a["cycles"],
        data_mem=u_elems * ACT_BYTES,
        weight_mem=2 * stream_group * k * n * ACT_BYTES,      # prefetch buffer
        accum_mem=votes * ACT_BYTES + ARRAY_DIM * n * ACC_BYTES,
        data_reads=a["data_reads"],
        data_writes=float(u_elems),
        weight_reads=float(w_elems),
        weight_writes=float(w_elems),                          # streamed in
        accum_reads=a["accum_reads"],
        accum_writes=a["accum_writes"] + votes,
    )


def _routing_state_mem(dims: CapsNetDims) -> tuple[float, float]:
    """(accumulator-resident routing state, coupling-coefficient bytes)."""
    votes = dims.num_primary * dims.num_classes * dims.class_dim * ACT_BYTES
    logits = dims.num_primary * dims.num_classes * ACC_BYTES
    s = dims.num_classes * dims.class_dim * ACC_BYTES
    return votes + logits + s, dims.num_primary * dims.num_classes * ACT_BYTES


def sum_squash_profile(dims: CapsNetDims = MNIST_DIMS) -> OperationProfile:
    # s_j = sum_i c_ij * u_hat_ij ; v_j = squash(s_j); executed per iteration.
    votes = dims.num_primary * dims.num_classes * dims.class_dim
    macs = float(votes)                       # one MAC per vote element
    m, k = dims.num_classes * dims.class_dim, dims.num_primary
    cycles = float(_tiles(m) * k)             # reduction over i, 16 cols wide
    acc_state, c_bytes = _routing_state_mem(dims)
    v_elems = dims.num_classes * dims.class_dim
    return OperationProfile(
        name="Sum+Squash",
        macs=macs,
        cycles=cycles + v_elems * 4,          # squash pipeline tail
        data_mem=v_elems * ACT_BYTES * 4,     # v + squash temporaries
        weight_mem=c_bytes,                   # c_ij act as weights
        accum_mem=acc_state,
        data_reads=float(v_elems * 2),
        data_writes=float(v_elems),
        weight_reads=float(dims.num_primary * dims.num_classes),
        weight_writes=0.0,
        accum_reads=float(votes),             # u_hat streamed from accum mem
        accum_writes=float(m * _tiles(k)),
        repeats=dims.routing_iters,
    )


def update_sum_profile(dims: CapsNetDims = MNIST_DIMS) -> OperationProfile:
    # b_ij += u_hat_ij . v_j ; c = softmax_j(b): executed per iteration.
    votes = dims.num_primary * dims.num_classes * dims.class_dim
    macs = float(votes)
    m, k = dims.num_primary * dims.num_classes, dims.class_dim
    cycles = float(_tiles(m) * k)
    acc_state, c_bytes = _routing_state_mem(dims)
    v_elems = dims.num_classes * dims.class_dim
    bij = dims.num_primary * dims.num_classes
    return OperationProfile(
        name="Update+Sum",
        macs=macs,
        cycles=cycles + bij / ARRAY_DIM,      # softmax pass
        data_mem=v_elems * ACT_BYTES * 4,
        weight_mem=c_bytes + v_elems * ACT_BYTES,
        accum_mem=acc_state,
        data_reads=float(v_elems),
        data_writes=0.0,
        weight_reads=float(v_elems + bij),    # v + c refresh
        weight_writes=float(bij),             # softmax result -> c
        accum_reads=float(votes + bij),
        accum_writes=float(bij),
        repeats=dims.routing_iters,
    )


def _linebuf_convs(c1: OperationProfile, pc: OperationProfile,
                   dims: CapsNetDims) -> tuple[OperationProfile,
                                               OperationProfile]:
    """'linebuf' conv variants: kernel-height line buffer of the input
    plus a 3-row accumulator strip instead of full-fmap residency."""
    c1 = dataclasses.replace(
        c1, accum_mem=3 * dims.conv1_out * dims.conv1_cout * ACC_BYTES)
    pc = dataclasses.replace(
        pc,
        data_mem=dims.pc_k * dims.conv1_out * dims.pc_cin * ACT_BYTES,
        accum_mem=3 * dims.pc_out * dims.pc_cout * ACC_BYTES,
        # input streamed from off-chip once per 16-channel output group
        data_writes=pc.data_writes * max(dims.pc_cout // ARRAY_DIM, 1),
    )
    return c1, pc


def _linebuf_routing(cc: OperationProfile, ss: OperationProfile,
                     us: OperationProfile, ldims) -> tuple[OperationProfile,
                                                           OperationProfile,
                                                           OperationProfile]:
    """'linebuf' routing variants for ONE layer: the votes live in the
    DATA memory during routing (``ldims``: the layer's own shape)."""
    votes_b = (ldims.num_primary * ldims.num_classes * ldims.class_dim
               * ACT_BYTES)
    logits_b = ldims.num_primary * ldims.num_classes * ACC_BYTES
    # s/v accumulator state: 4 fp32 temporaries per class-capsule element
    # (2560 B for the default MNIST network).
    sv_b = 4 * ldims.num_classes * ldims.class_dim * ACC_BYTES
    cc = dataclasses.replace(
        cc, data_mem=cc.data_mem + votes_b,                    # votes in data
        accum_mem=ARRAY_DIM * ldims.num_classes * ldims.class_dim * ACC_BYTES)
    ss = dataclasses.replace(ss, data_mem=votes_b + ss.data_mem,
                             accum_mem=logits_b + sv_b)
    us = dataclasses.replace(us, data_mem=votes_b + us.data_mem,
                             accum_mem=logits_b + sv_b)
    return cc, ss, us


def _linebuf_variant(ops: list[OperationProfile],
                     dims: CapsNetDims) -> list[OperationProfile]:
    """Alternative dataflow ('linebuf') of the fixed five-op model.  The
    paper's Fig. 4 bar values are not recoverable from the text, so both
    dataflows are exposed:
    'resident' (default) satisfies all of the paper's qualitative claims;
    'linebuf' trades PrimaryCaps footprint for higher power-gating
    headroom (closer to the paper's published PG savings)."""
    c1, pc, cc, ss, us = ops
    c1, pc = _linebuf_convs(c1, pc, dims)
    cc, ss, us = _linebuf_routing(cc, ss, us, dims)
    return [c1, pc, cc, ss, us]


def capsnet_stack_profiles(dataflow: str = "resident",
                           dims: CapsNetDims = MNIST_DIMS,
                           layers=None) -> list[OperationProfile]:
    """Per-operation profiles for a CHAIN of routing-capsule layers.

    ``layers`` describes the routing stack as ``(suffix, in_caps, in_dim,
    num_caps, caps_dim, iters)`` tuples (``None``: the single ClassCaps
    layer of ``dims`` -- exactly ``capsnet_profiles``).  Each layer
    contributes the three routing operations via ``RoutingLayerDims``
    with ``suffix`` appended to the names (repeated layers must not
    collide on a profile/phase name), so a deep stack is
    ``[Conv1, PrimaryCaps, FC[0], SS[0], US[0], ..., FC, SS, US]``.

    Off-chip accesses generalize paper Eq. (1)/(2): the DRAM-LOADING ops
    (the convs and each layer's FC, which stream weights/activations in)
    get reads = their on-chip fills; a loader's produced feature map is
    spilled (writes) when its consumer is the NEXT loader -- Conv1 ->
    PrimaryCaps -> FC[0] -> ... -> FC -- while the final FC's output and
    every routing phase stay on-chip.  DRAM-stall cycles apply uniformly.
    """
    from repro_torch.core.energy import DRAM_BYTES_PER_CYCLE

    if layers is None:
        layers = (("", dims.num_primary, dims.primary_dim,
                   dims.num_classes, dims.class_dim, dims.routing_iters),)
    ops = [conv1_profile(dims), primarycaps_profile(dims)]
    loaders = [0, 1]                     # indices of DRAM-loading ops
    for suffix, in_caps, in_dim, num_caps, caps_dim, iters in layers:
        ld = RoutingLayerDims(num_primary=in_caps, primary_dim=in_dim,
                              num_classes=num_caps, class_dim=caps_dim,
                              routing_iters=iters)
        cc, ss, us = (classcaps_fc_profile(ld), sum_squash_profile(ld),
                      update_sum_profile(ld))
        if dataflow == "linebuf":
            cc, ss, us = _linebuf_routing(cc, ss, us, ld)
        if suffix:
            cc, ss, us = (dataclasses.replace(p, name=p.name + suffix)
                          for p in (cc, ss, us))
        loaders.append(len(ops))
        ops.extend([cc, ss, us])
    if dataflow == "linebuf":
        ops[0], ops[1] = _linebuf_convs(ops[0], ops[1], dims)
    elif dataflow != "resident":
        raise ValueError(f"unknown dataflow {dataflow!r}")
    loader_pos = {idx: n for n, idx in enumerate(loaders)}
    out = []
    for i, op in enumerate(ops):
        if i in loader_pos:
            n = loader_pos[i]
            reads = op.weight_writes + op.data_writes          # Eq. (1)
            nxt = loaders[n + 1] if n + 1 < len(loaders) else None
            writes = ops[nxt].data_writes if nxt is not None else 0.0  # Eq. (2)
        else:
            reads = writes = 0.0                               # routing: on-chip
        # Operations stall when the DRAM interface cannot keep up with the
        # streamed weights (ClassCaps-FC is memory-bound: its 2.8 MiB of
        # reuse-free weights dominate its runtime).
        stream_cycles = (reads + writes) * ACT_BYTES / DRAM_BYTES_PER_CYCLE
        out.append(dataclasses.replace(
            op, offchip_reads=reads, offchip_writes=writes,
            cycles=max(op.cycles, stream_cycles / max(op.repeats, 1))))
    return out


def capsnet_profiles(dataflow: str = "resident",
                     dims: CapsNetDims = MNIST_DIMS) -> list[OperationProfile]:
    """The five operations of CapsuleNet inference, with off-chip traffic.

    Off-chip accesses follow paper Eq. (1)/(2): reads_i = on-chip fills
    (weight_writes + data_writes) of op i; writes_i = data fills of op i+1
    (the produced feature map is spilled and re-read).  The last two ops
    (routing) never touch off-chip memory.

    ``dataflow``: "resident" (default, full-fmap residency) or "linebuf"
    (see ``_linebuf_variant``).  ``dims`` selects the network shape
    (default: the paper's MNIST CapsuleNet).  The single-layer special
    case of ``capsnet_stack_profiles``.
    """
    return capsnet_stack_profiles(dataflow, dims)


# ---------------------------------------------------------------------------
# Aggregates used by the DSE and benchmarks
# ---------------------------------------------------------------------------

COMPONENTS = ("data", "weight", "accum")


def peak_total_mem(profiles: Sequence[OperationProfile]) -> float:
    return max(p.total_mem for p in profiles)


def peak_component_mem(profiles: Sequence[OperationProfile], comp: str) -> float:
    return max(p.component(comp) for p in profiles)


def min_component_mem(profiles: Sequence[OperationProfile], comp: str) -> float:
    return min(p.component(comp) for p in profiles)


def total_cycles(profiles: Sequence[OperationProfile]) -> float:
    return sum(p.total_cycles for p in profiles)


def total_macs(profiles: Sequence[OperationProfile]) -> float:
    return sum(p.macs * p.repeats for p in profiles)


def total_offchip_accesses(profiles: Sequence[OperationProfile]) -> float:
    return sum((p.offchip_reads + p.offchip_writes) * p.repeats for p in profiles)
