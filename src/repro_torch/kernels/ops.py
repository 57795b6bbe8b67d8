"""Plan-aware wrappers for the port's kernels, driven by one ExecutionPlan.

The counterparts of ``repro/kernels/ops.py``'s ``conv2d``,
``votes_routing``, ``primary_routing``, ``res_caps_segment`` (the
reversible ResCaps segment, K12), the split path's ``caps_votes`` and
``routing``, ``squash``, and the LM side's ``rmsnorm`` (K16) and
``flash_attention`` (K15).  Tiles and schedules come from an
``ExecutionPlan`` (``repro_torch.core.execplan.compile_plan``) when one is
passed; otherwise the planner's pick is computed once per shape and
memoized in a bounded cache.  CPU tensors run the plain twins, CUDA
tensors the kernels (see each kernel module).

The conv, routing, segment and squash wrappers are differentiable
(``caps_votes``, ``routing``, ``rmsnorm`` and ``flash_attention`` are
forward only, as in the reference).  The backward
schedule comes from the plan's ``<op>-bwd`` entry on a training plan
(``compile_plan(train=True)``); otherwise the routing backward plans its
own when it runs (``votes_routing.planned_votes_routing_bwd``), so a
forward that is never differentiated plans no backward.

Every wrapper ends in the reference's fault site, ``if faults.enabled():
out = faults.corrupt_array(SITE_..., out)``: one global load when nothing
is injected.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import execplan, faults
from repro_torch.core.planner import SMEM_BYTES, MatmulWorkload, plan_matmul
from repro_torch.kernels.caps_votes import caps_votes as _caps_votes
from repro_torch.kernels.conv_im2col import conv2d_im2col, out_size
from repro_torch.kernels.flash_attention import \
    flash_attention as _flash_attention
from repro_torch.kernels.primary_routing import \
    planned_primary_routing  # noqa: F401  (the K5 plan decision, memoized)
from repro_torch.kernels.primary_routing import \
    primary_routing as _primary_routing
from repro_torch.kernels.rmsnorm import rmsnorm as _rmsnorm
from repro_torch.kernels.routing import routing as _routing
from repro_torch.kernels.squash import squash as _squash
from repro_torch.kernels.votes_routing import RoutingStatics
from repro_torch.kernels.votes_routing import \
    res_caps_segment as _res_caps_segment
from repro_torch.kernels.votes_routing import votes_routing as _votes_routing


@functools.lru_cache(maxsize=64)            # m folds in the batch: bounded
def planned_conv_blocks(m: int, k: int, n: int,
                        squash_dim: int = 0) -> tuple[int, int, int, int]:
    """Planner pick of a conv's GEMM tiles and K split, ``(block_m,
    block_k, block_n, split_k)`` (memoized)."""
    return plan_matmul(MatmulWorkload(m=m, k=k, n=n),
                       n_multiple=max(squash_dim, 1),
                       stage_output=squash_dim > 0).tiles


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
           stride: int = 1, plan_op=None, bwd_op=None,
           epilogue: str = "none", squash_dim: int = 0) -> torch.Tensor:
    """Plan-driven im2col conv: x [B,H,W,Cin], w [KH,KW,Cin,Cout] (HWIO)
    -> epilogue(conv(x, w) + b) [B, OH, OW, Cout].  A plan op that fuses
    the squash (``plan_op.fuses_squash``) forces the squash epilogue;
    callers supply ``squash_dim``.  ``bwd_op`` (the plan's ``<op>-bwd``)
    gives the backward's dpatches tiles."""
    kh, kw, cin, cout = w.shape
    oh = out_size(x.shape[1], kh, stride)
    ow = out_size(x.shape[2], kw, stride)
    m, k = x.shape[0] * oh * ow, kh * kw * cin
    if plan_op is not None:
        block = plan_op.block.tiles
        if plan_op.fuses_squash:
            epilogue = "squash"
    else:
        block = planned_conv_blocks(
            m, k, cout, squash_dim if epilogue == "squash" else 0)
    dx_block = (bwd_op.dx_block.tiles if bwd_op is not None
                else planned_conv_blocks(m, cout, k))
    out = conv2d_im2col(x, w, b, stride=stride, block=block,
                        dx_block=dx_block, epilogue=epilogue,
                        squash_dim=squash_dim)
    if faults.enabled():                 # chaos-test site; zero cost when off
        out = faults.corrupt_array(faults.SITE_CONV2D, out)
    return out


@functools.lru_cache(maxsize=64)            # the batch is a key: bounded
def planned_votes_routing(num_caps: int, caps_dim: int, jd: int,
                          num_classes: int, iters: int, batch: int = 1
                          ) -> tuple[str, int, int | None]:
    """Memoized (mode, block_i, cluster) decision for ``votes_routing`` at
    ``batch`` (``cluster``: K3/K4's CTAs a sample)."""
    sched = execplan.plan_votes_routing(num_caps, caps_dim, jd, num_classes,
                                        iters=iters, batch=batch)
    return (sched.mode, sched.block_i,
            sched.cluster.cluster if sched.cluster else None)


def _bwd_schedule(plan, op_name: str
                  ) -> tuple[str | None, int | None, int | None]:
    """The plan's ``<op_name>-bwd`` routing schedule ``(mode, block_i,
    cluster)``, or all None for the backward to plan."""
    bwd = plan.bwd_op(op_name) if plan is not None else None
    return ((bwd.mode, bwd.block_i, bwd.cluster) if bwd is not None
            else (None, None, None))


def votes_routing(u: torch.Tensor, w: torch.Tensor, *, plan=None,
                  op_name: str | None = None, iters: int | None = None,
                  num_classes: int | None = None) -> torch.Tensor:
    """u: [B, I, C], w: [I, J*D, C] -> v: [B, J*D].  The schedule comes
    from ``plan.op(op_name)`` (default ``"ClassCaps-Routing"``, the final
    layer) or the memoized plan decision; the backward's as
    ``_bwd_schedule`` says."""
    op_name = op_name or execplan.FUSED_NAME
    if iters is None:
        iters = plan.cfg.routing_iters if plan is not None else 3
    if num_classes is None:
        num_classes = plan.cfg.num_classes if plan is not None else 10
    if plan is not None:
        op = plan.op(op_name)
        mode, block_i, cluster = op.mode, op.block_i, op.cluster
    else:
        mode, block_i, cluster = planned_votes_routing(
            u.shape[1], u.shape[2], w.shape[1], num_classes, iters,
            u.shape[0])
    bwd_mode, bwd_block_i, bwd_cluster = _bwd_schedule(plan, op_name)
    out = _votes_routing(u, w, iters=iters, num_classes=num_classes,
                         mode=mode, block_i=block_i, cluster=cluster,
                         bwd_mode=bwd_mode, bwd_block_i=bwd_block_i,
                         op_name=op_name, bwd_cluster=bwd_cluster)
    if faults.enabled():                 # chaos-test site; zero cost when off
        out = faults.corrupt_array(faults.SITE_VOTES_ROUTING, out)
    return out


def _layer_schedule(lay, plan, batch: int) -> RoutingStatics:
    """One routing layer's kernel statics: its forward schedule from the
    plan's op (or the memoized plan decision at ``batch``), its backward
    schedule from a training plan's ``<op>-bwd`` (else planned when the
    backward runs, whose ``PlanError`` names the ``-bwd`` op)."""
    if plan is not None:
        op = plan.op(lay.name)
        mode, block_i, cluster = op.mode, op.block_i, op.cluster
    else:
        mode, block_i, cluster = planned_votes_routing(
            lay.in_caps, lay.in_dim, lay.jd, lay.num_caps, lay.iters, batch)
    bwd_mode, bwd_block_i, bwd_cluster = _bwd_schedule(plan, lay.name)
    return RoutingStatics(iters=lay.iters, num_classes=lay.num_caps,
                          mode=mode, block_i=block_i, bwd_mode=bwd_mode,
                          bwd_block_i=bwd_block_i, op_name=lay.name,
                          bwd_cluster=bwd_cluster, cluster=cluster)


def res_caps_segment(x: torch.Tensor, ws, pairs, *,
                     plan=None) -> torch.Tensor:
    """Reversible residual capsule segment (K12): x [B, I, C] through a
    maximal run of ``ResCapsBlock`` coupling pairs -> [B, I, C].

    ``pairs`` is a tuple of ``(f_layer, g_layer)`` ``RoutingLayer`` pairs
    (from ``CapsNetConfig.routing_stack()``); ``ws`` the matching flat
    per-half weights ``[in_caps, jd, in_dim]``.  Each half runs the fused
    votes+routing kernel with the residual-add epilogue on its own plan
    op's schedule.  Differentiable with no saved activations: the
    backward inverts the coupling block by block from the segment output
    (``kernels.votes_routing.ResCapsSegment``)."""
    if plan is not None and x.shape[0] > plan.batch:
        raise ValueError(
            f"res_caps_segment: batch {x.shape[0]} exceeds the plan's "
            f"batch {plan.batch}; recompile the plan for this batch")
    blocks = tuple((lf.num_caps, _layer_schedule(lf, plan, x.shape[0]),
                    _layer_schedule(lg, plan, x.shape[0]))
                   for lf, lg in pairs)
    out = _res_caps_segment(x, tuple(ws), blocks=blocks)
    if faults.enabled():                 # chaos-test site; zero cost when off
        out = faults.corrupt_array(faults.SITE_RES_CAPS_SEGMENT, out)
    return out


def primary_routing(x: torch.Tensor, w_pc: torch.Tensor, b_pc: torch.Tensor,
                    w_cc: torch.Tensor, *, plan=None,
                    stride: int | None = None, iters: int | None = None,
                    num_classes: int | None = None,
                    routing_op_name: str | None = None) -> torch.Tensor:
    """Pipelined PrimaryCaps conv + votes/routing as ONE kernel: x is the
    Conv1 output [B, H, W, Cin], w_pc/b_pc the PrimaryCaps conv params,
    w_cc [I, J*D, C] the routing weights -> v [B, J*D].  The schedule
    (votes placement, i-tile, cluster size) comes from
    ``plan.op("PrimaryCaps-Routing")`` or the memoized plan decision at
    this batch; the backward's routing schedule from the plan's
    ``<routing_op_name>-bwd`` (default ``"ClassCaps-Routing"``), its conv
    tiles from ``PrimaryCaps-bwd`` (or the memoized picks)."""
    if stride is None:
        stride = plan.cfg.pc_stride if plan is not None else 2
    if iters is None:
        iters = plan.cfg.routing_iters if plan is not None else 3
    if num_classes is None:
        num_classes = plan.cfg.num_classes if plan is not None else 10
    kh, kw, cin, n_ch = w_pc.shape
    oh = out_size(x.shape[1], kh, stride)
    ow = out_size(x.shape[2], kw, stride)
    num_caps, jd, caps_dim = w_cc.shape
    m, k = x.shape[0] * oh * ow, kh * kw * cin
    if plan is not None:
        op = plan.op(execplan.PIPE_NAME)
        mode, block_i, cluster = op.mode, op.block_i, op.cluster
    else:
        mode, block_i, cluster = planned_primary_routing(
            oh * ow, k, n_ch, num_caps, caps_dim, jd, num_classes, iters,
            x.shape[0])
    routing_op_name = routing_op_name or execplan.FUSED_NAME
    bwd_mode, bwd_block_i, bwd_cluster = _bwd_schedule(plan, routing_op_name)
    pc_bwd = plan.bwd_op("PrimaryCaps") if plan is not None else None
    if pc_bwd is not None:
        conv_block, dx_block = pc_bwd.block.tiles, pc_bwd.dx_block.tiles
    else:
        conv_block = planned_conv_blocks(m, k, n_ch, caps_dim)
        dx_block = planned_conv_blocks(m, n_ch, k)
    out = _primary_routing(x, w_pc, b_pc, w_cc, stride=stride, iters=iters,
                           num_classes=num_classes, mode=mode,
                           block_i=block_i, cluster=cluster,
                           bwd_mode=bwd_mode, bwd_block_i=bwd_block_i,
                           bwd_cluster=bwd_cluster,
                           routing_op_name=routing_op_name,
                           conv_block=conv_block, dx_block=dx_block)
    if faults.enabled():                 # chaos-test site; zero cost when off
        out = faults.corrupt_array(faults.SITE_PRIMARY_ROUTING, out)
    return out


@functools.lru_cache(maxsize=64)            # the batch is a key: bounded
def planned_block_i(num_caps: int, caps_dim: int, out_dim: int,
                    batch: int = 1, smem_budget: int = SMEM_BYTES) -> int:
    """Memoized ``execplan.plan_caps_votes`` pick of the split votes'
    i-tile at the real batch (its footprint holds a chunk of samples'
    u)."""
    return execplan.plan_caps_votes(num_caps, caps_dim, out_dim, batch,
                                    smem_budget)


def caps_votes(u: torch.Tensor, w: torch.Tensor, *, plan=None,
               block_i: int | None = None) -> torch.Tensor:
    """u: [B, I, C], w: [I, N, C] -> u_hat [B, I, N] (K14a, the split
    path's votes; the plan executes the fused ``votes_routing`` instead).
    Unless given, ``block_i`` is the planner's pick at this batch, under
    ``plan``'s shared-memory budget when a plan is passed: the plan has
    no op of its own for the split path, and its routing i-tile is sized
    for K3/K4's footprint, not this kernel's."""
    if block_i is None:
        budget = plan.smem_budget if plan is not None else SMEM_BYTES
        block_i = planned_block_i(u.shape[1], u.shape[2], w.shape[1],
                                  u.shape[0], budget)
    out = _caps_votes(u, w, block_i=block_i)
    if faults.enabled():                 # chaos-test site; zero cost when off
        out = faults.corrupt_array(faults.SITE_CAPS_VOTES, out)
    return out


@functools.lru_cache(maxsize=64)            # the batch is a key: bounded
def planned_routing(num_caps: int, j: int, jd: int, iters: int = 3,
                    batch: int = 1, smem_budget: int = SMEM_BYTES
                    ) -> tuple[str, int, int]:
    """Memoized ``execplan.plan_routing_split`` decision for K14b at
    ``batch``: ``(mode, block_i, cluster)``, the placement of each CTA's
    rows of u_hat, their tile and the cluster's CTAs a sample."""
    sched = execplan.plan_routing_split(num_caps, j, jd, iters=iters,
                                        batch=batch, smem_budget=smem_budget)
    return sched.mode, sched.block_i, sched.cluster.cluster


def routing(u_hat: torch.Tensor, *, plan=None, iters: int | None = None,
            num_classes: int | None = None) -> torch.Tensor:
    """u_hat: [B, I, J*D] -> v [B, J*D] (K14b: every routing iteration
    over the materialized votes, each sample on a thread-block cluster,
    on the planner's schedule at this batch).  ``iters`` /
    ``num_classes`` default to the plan's config, else 3 and 10."""
    if iters is None:
        iters = plan.cfg.routing_iters if plan is not None else 3
    if num_classes is None:
        num_classes = plan.cfg.num_classes if plan is not None else 10
    budget = plan.smem_budget if plan is not None else SMEM_BYTES
    mode, block_i, cluster = planned_routing(
        u_hat.shape[1], num_classes, u_hat.shape[2], iters,
        max(u_hat.shape[0], 1), budget)
    out = _routing(u_hat, iters=iters, num_classes=num_classes, mode=mode,
                   block_i=block_i, cluster=cluster)
    if faults.enabled():                 # chaos-test site; zero cost when off
        out = faults.corrupt_array(faults.SITE_ROUTING, out)
    return out


def squash(x: torch.Tensor, *, plan=None,
           block_rows: int | None = None) -> torch.Tensor:
    """x [..., D] -> squash over the last axis (K10, differentiable).
    ``block_rows`` (rows per CTA) comes from ``plan.op("PrimaryCaps")``
    when a plan is passed, else the Hopper pick for D."""
    if block_rows is None and plan is not None:
        block_rows = plan.op("PrimaryCaps").block_rows
    out = _squash(x, block_rows=block_rows)
    if faults.enabled():                 # chaos-test site; zero cost when off
        out = faults.corrupt_array(faults.SITE_SQUASH, out)
    return out


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x [..., D] (fp32 or bf16), weight [D] -> RMSNorm with fp32
    statistics in x's type (K16)."""
    out = _rmsnorm(x, weight, eps=eps)
    if faults.enabled():                 # chaos-test site; zero cost when off
        out = faults.corrupt_array(faults.SITE_RMSNORM, out)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None, scale: float | None = None,
                    kv_len: torch.Tensor | None = None) -> torch.Tensor:
    """q: [B, H, Tq, D], k/v: [B, KvH, Tk, D] -> [B, H, Tq, D] (K15).

    The reference's signature and layout; its TPU tiles (``block_q``,
    ``block_k``) give way to the kernel's two schedules: split-KV decode
    where a KV head's query rows are few (``flash_attention.plan_decode``),
    else prefill on the shared-memory planner's tile
    (``flash_attention.plan_tiles``).  K/V may hold fewer heads than q
    (GQA by index), and ``kv_len`` gives each batch row its own key count
    (``q_offset = kv_len - Tq``), clamped to ``0 .. Tk``; a row of no
    keys returns 0.  The kernel reads the transposed views
    in place; the result is a ``[B, H, Tq, D]`` view of ``[B, Tq, H, D]``
    memory, so a caller in the model's layout transposes it back for
    free."""
    b, h, tq, d = q.shape
    out = torch.empty((b, tq, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    _flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                     v.transpose(1, 2), kv_len=kv_len, causal=causal,
                     window=window, softcap=softcap, scale=scale,
                     out=out.transpose(1, 2))
    if faults.enabled():                 # chaos-test site; zero cost when off
        out = faults.corrupt_array(faults.SITE_FLASH_ATTENTION, out)
    return out
