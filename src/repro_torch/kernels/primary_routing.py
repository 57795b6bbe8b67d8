"""Pipelined PrimaryCaps -> routing kernel (K5): u never leaves the chip.

The counterpart of ``repro/kernels/primary_routing.py``: the forward
(``_produce_u`` + ``_pipe_resident_kernel`` / ``_pipe_streamed_kernel``
through ``_pr_apply``) and the custom VJP (``_pr_core``, whose backward
``_pr_grad`` is the K11 composite).  ``primary_routing`` is a
``torch.autograd.Function``: its forward extracts the PrimaryCaps
patches with K1, as ``_pr_apply`` does, then runs
``primary_routing_patches`` -- the plain twin for CPU tensors, the CUDA
kernel (``csrc/primary_routing.cu``, each sample on a thread-block
cluster of ``cluster`` CTAs) for CUDA tensors.  Capsule row ``i = p *
groups + g`` of u is channels ``[g*C, (g+1)*C)`` of patch position ``p``,
so the producer's output rows are the capsule rows with no reshuffle;
cluster rank r produces and routes the groups ``[r G/cs, (r+1) G/cs)``
at every position, and the twin sums s over each rank's rows in that
order before adding the ranks' partials in rank order.  ``cluster``
None takes the planner's size at the call's batch.

The backward saves only ``(x, W_pc, b_pc, W_cc)`` and recomputes u from
the patches (K1, K2), runs the routing backward (K8/K9) on it, pulls the
squash VJP, and finishes with the conv backward's kernels (K6, K2, K7):
exactly the per-op backward, so a pipelined training plan keeps the
per-op backward schedule.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core.execplan import (PIPE_MAX_CHANNELS, PIPE_MAX_POSITIONS,
                                       pipe_cluster_sizes,
                                       plan_primary_routing,
                                       primary_routing_smem)
from repro_torch.core.planner import SMEM_BYTES
from repro_torch.kernels import ref
from repro_torch.kernels.build import (Kernel, cluster_query, on_cpu, ptr,
                                       stream_of)
from repro_torch.kernels.conv_im2col import (conv_bwd_from_dpre,
                                             gemm_tiles, im2col_patches)
from repro_torch.kernels.votes_routing import (FUSED_NAME, RoutingStatics,
                                               check_schedule,
                                               cluster_routing_plain,
                                               routing_bwd, routing_statics)

_P, _I = ctypes.c_void_p, ctypes.c_int
PRIMARY_ROUTING = Kernel("primary_routing", "primary_routing_f32",
                         [_P] * 5 + [_I] * 12 + [_P])


@functools.lru_cache(maxsize=64)            # the batch is a key: bounded
def planned_primary_routing(p_pos: int, k_in: int, n_ch: int, num_caps: int,
                            caps_dim: int, jd: int, num_classes: int,
                            iters: int, batch: int = 1
                            ) -> tuple[str, int, int]:
    """Memoized (mode, block_i, cluster) decision for ``primary_routing``
    at ``batch``; raises the planner's ``PlanError`` where none fits."""
    sched = plan_primary_routing(p_pos, k_in, n_ch, num_caps, caps_dim, jd,
                                 num_classes, iters=iters, batch=batch)
    return sched.mode, sched.block_i, sched.cluster.cluster


def primary_routing_patches_plain(patches: torch.Tensor, w_pc: torch.Tensor,
                                  b_pc: torch.Tensor, w_cc: torch.Tensor, *,
                                  iters: int, num_classes: int, mode: str,
                                  block_i: int,
                                  cluster: int = 1) -> torch.Tensor:
    """patches [B, P, K], w_pc [K, N], b_pc [N], w_cc [I, J*D, C] ->
    v [B, J*D]: the produce phase (GEMM + bias + per-capsule squash),
    then the cluster's votes + routing on u: the capsule rows are taken in
    rank-major order (rank r's groups at each position), so that each
    rank's rows are one block (``cluster_routing_plain``)."""
    bsz, p_pos, _ = patches.shape
    i_dim, _, caps_dim = w_cc.shape
    groups = i_dim // p_pos
    u = ref.squash((patches @ w_pc + b_pc).reshape(bsz, i_dim, caps_dim))
    order = torch.arange(i_dim, device=u.device).reshape(
        p_pos, cluster, groups // cluster).transpose(0, 1).reshape(-1)
    return cluster_routing_plain(u[:, order], w_cc[order], iters=iters,
                                 num_classes=num_classes, mode=mode,
                                 block_i=block_i, cluster=cluster)


def primary_routing_patches(patches: torch.Tensor, w_pc: torch.Tensor,
                            b_pc: torch.Tensor, w_cc: torch.Tensor, *,
                            iters: int = 3, num_classes: int = 10,
                            mode: str = "streamed", block_i: int = 128,
                            cluster: int | None = None) -> torch.Tensor:
    """K5 from the PrimaryCaps patches (see ``primary_routing``):
    ``cluster`` CTAs a sample (None: the planner's at this batch).  The
    card's producer runs stages of ``execplan.PIPE_BLOCK_K`` K values."""
    bsz, p_pos, kk = patches.shape
    n_ch = w_pc.shape[1]
    i_dim, jd, caps_dim = w_cc.shape
    if w_pc.shape[0] != kk or b_pc.shape != (n_ch,) or n_ch % caps_dim \
            or p_pos * (n_ch // caps_dim) != i_dim:
        raise ValueError(
            f"primary_routing: patches {tuple(patches.shape)}, W_pc "
            f"{tuple(w_pc.shape)}, W_cc {tuple(w_cc.shape)}: the producer "
            f"must emit the {i_dim} capsules W_cc expects")
    j = num_classes
    if cluster is None:
        cluster = planned_primary_routing(p_pos, kk, n_ch, i_dim, caps_dim,
                                          jd, j, iters, bsz)[2]
    sizes = pipe_cluster_sizes(p_pos, n_ch, caps_dim)
    if cluster not in sizes:
        raise ValueError(f"primary_routing: a cluster of {cluster} CTAs; "
                         f"{n_ch} channels of {caps_dim}D capsules split "
                         f"over {sizes}")
    rows = i_dim // cluster
    block_i = min(block_i, rows)
    check_schedule(rows, jd, iters=iters, num_classes=j, mode=mode,
                   block_i=block_i)
    if on_cpu("primary_routing", patches, w_pc, b_pc, w_cc):
        return primary_routing_patches_plain(
            patches, w_pc, b_pc, w_cc, iters=iters, num_classes=j,
            mode=mode, block_i=block_i, cluster=cluster)
    if mode not in ("resident", "streamed") or p_pos > PIPE_MAX_POSITIONS \
            or n_ch > PIPE_MAX_CHANNELS:
        raise ValueError(
            f"primary_routing: {mode!r} votes and a {p_pos} x {n_ch} tile "
            f"are outside the kernel's limits (resident or streamed, "
            f"{PIPE_MAX_POSITIONS} x {PIPE_MAX_CHANNELS})")
    smem = primary_routing_smem(mode, p_pos, n_ch, block_i, caps_dim, j, jd,
                                cluster)
    if smem > SMEM_BYTES:
        raise ValueError(f"primary_routing: the {mode} schedule on "
                         f"{cluster}-CTA clusters needs {smem} B of shared "
                         f"memory per CTA, over {SMEM_BYTES} B")
    out = torch.empty((bsz, jd), dtype=patches.dtype, device=patches.device)
    try:
        PRIMARY_ROUTING(ptr(patches), ptr(w_pc), ptr(b_pc), ptr(w_cc),
                        ptr(out), bsz, p_pos, kk, n_ch, caps_dim, j, jd // j,
                        iters, int(mode == "resident"), block_i, cluster,
                        smem, stream_of(patches))
    except RuntimeError as err:
        raise RuntimeError(
            f"primary_routing: the launch of {bsz} clusters of {cluster} "
            f"CTAs ({smem} B of shared memory each) was refused: "
            f"{err}") from err
    return out


def occupancy(p_pos: int, n_ch: int, caps_dim: int, num_classes: int,
              out_dim: int, *, mode: str, block_i: int,
              cluster: int) -> dict[str, int]:
    """On the card: how many K5 clusters of this schedule run at once, and
    the kernel's attributes (``build.cluster_query``); ``out_dim`` is the
    next layer's capsule size D."""
    return cluster_query("primary_routing", "primary_routing_occupancy",
                         p_pos, n_ch, caps_dim, num_classes, out_dim,
                         cluster, int(mode == "resident"), block_i)


class PrimaryStatics(NamedTuple):
    """Schedule of one pipelined call: the stride, the routing statics,
    the cluster size, and the conv tiles the backward's recompute and
    dpatches GEMMs run on."""

    stride: int
    routing: RoutingStatics
    cluster: int | None
    conv_block: tuple[int, ...]
    dx_block: tuple[int, ...]


class _PrimaryRouting(torch.autograd.Function):
    """The reference's ``_pr_core`` custom VJP (backward: ``_pr_grad``)."""

    @staticmethod
    def forward(ctx, x, w_pc, b_pc, w_cc, st: PrimaryStatics):
        kh, kw, cin, n_ch = w_pc.shape
        rt = st.routing
        patches = im2col_patches(x, kh=kh, kw=kw, stride=st.stride)
        ctx.st = st
        ctx.save_for_backward(x, w_pc, b_pc, w_cc)
        return primary_routing_patches(
            patches, w_pc.reshape(kh * kw * cin, n_ch), b_pc, w_cc,
            iters=rt.iters, num_classes=rt.num_classes, mode=rt.mode,
            block_i=rt.block_i, cluster=st.cluster)

    @staticmethod
    def backward(ctx, g):
        x, w_pc, b_pc, w_cc = ctx.saved_tensors
        st, rt = ctx.st, ctx.st.routing
        need_x, need_wpc, need_bpc, need_wcc = ctx.needs_input_grad[:4]
        bsz = x.shape[0]
        kh, kw, _, n_ch = w_pc.shape
        i_dim, _, caps_dim = w_cc.shape
        patches = im2col_patches(x, kh=kh, kw=kw, stride=st.stride)
        p2 = patches.reshape(-1, patches.shape[2])
        pre = gemm_tiles(st.conv_block, p2, w_pc.reshape(-1, n_ch),
                         b_pc).reshape(bsz, i_dim, caps_dim)
        du, dw_cc = routing_bwd(ref.squash(pre), w_cc, g, rt)
        dpre = ref.squash_vjp(pre, du).reshape(-1, n_ch)
        dx, dw_pc, db_pc = conv_bwd_from_dpre(
            dpre, p2, w_pc, stride=st.stride, dx_block=st.dx_block,
            x_shape=x.shape, need=(need_x, need_wpc, need_bpc))
        return dx, dw_pc, db_pc, (dw_cc if need_wcc else None), None


def primary_routing(x: torch.Tensor, w_pc: torch.Tensor, b_pc: torch.Tensor,
                    w_cc: torch.Tensor, *, stride: int = 2, iters: int = 3,
                    num_classes: int = 10, mode: str = "streamed",
                    block_i: int = 128, cluster: int | None = None,
                    bwd_mode: str | None = None,
                    bwd_block_i: int | None = None,
                    bwd_cluster: int | None = None,
                    routing_op_name: str = FUSED_NAME,
                    conv_block: tuple[int, ...] = (64, 16, 64),
                    dx_block: tuple[int, ...] = (64, 16, 64)
                    ) -> torch.Tensor:
    """x: [B, H, W, Cin] (Conv1 output), w_pc: [KH, KW, Cin, N] HWIO,
    b_pc: [N], w_cc: [I, J*D, C] -> v: [B, J*D].

    The PrimaryCaps conv (im2col GEMM + bias + per-capsule squash) and
    the votes + routing of the next layer, with u kept on chip, each
    sample on ``cluster`` CTAs (see ``primary_routing_patches``).
    Differentiable (see the module note): the routing backward runs as
    ``votes_routing``'s does for ``bwd_mode`` / ``bwd_block_i`` /
    ``bwd_cluster`` / ``routing_op_name``, the conv backward on
    ``conv_block`` (pre-activation recompute) and ``dx_block`` (dpatches)
    tiles."""
    if x.dim() != 4 or w_pc.dim() != 4 or w_pc.shape[2] != x.shape[3]:
        raise ValueError(f"primary_routing: x {tuple(x.shape)} and W_pc "
                         f"{tuple(w_pc.shape)} must be NHWC and HWIO with "
                         f"matching channels")
    rt = routing_statics(w_cc.shape[0], w_cc.shape[1], iters=iters,
                         num_classes=num_classes, mode=mode, block_i=block_i,
                         bwd_mode=bwd_mode, bwd_block_i=bwd_block_i,
                         op_name=routing_op_name, bwd_cluster=bwd_cluster)
    st = PrimaryStatics(stride=stride, routing=rt, cluster=cluster, conv_block=tuple(conv_block),
                        dx_block=tuple(dx_block))
    return _PrimaryRouting.apply(x, w_pc, b_pc, w_cc, st)
