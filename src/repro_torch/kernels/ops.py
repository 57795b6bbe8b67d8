"""Plan-aware wrappers for the port's kernels, driven by one ExecutionPlan.

The counterparts of ``repro/kernels/ops.py``'s ``conv2d``,
``votes_routing`` and ``primary_routing``.  Tiles and schedules come from
an ``ExecutionPlan`` (``repro_torch.core.execplan.compile_plan``) when
one is passed; otherwise the planner's pick is computed once per shape
and memoized in a bounded cache.  CPU tensors run the plain twins, CUDA
tensors the kernels (see each kernel module).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.core import execplan
from repro_torch.core.planner import MatmulWorkload, plan_matmul
from repro_torch.kernels.conv_im2col import (im2col_patches, matmul_bias_act,
                                             out_size)
from repro_torch.kernels.primary_routing import \
    primary_routing as _primary_routing
from repro_torch.kernels.votes_routing import votes_routing as _votes_routing


@functools.lru_cache(maxsize=64)            # m folds in the batch: bounded
def planned_conv_blocks(m: int, k: int, n: int,
                        squash_dim: int = 0) -> tuple[int, int, int]:
    """Planner pick of a conv's GEMM tiles (memoized)."""
    plan = plan_matmul(MatmulWorkload(m=m, k=k, n=n),
                       n_multiple=max(squash_dim, 1),
                       stage_output=squash_dim > 0)
    return plan.block_m, plan.block_k, plan.block_n


def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
           stride: int = 1, plan_op=None, epilogue: str = "none",
           squash_dim: int = 0) -> torch.Tensor:
    """Plan-driven im2col conv: x [B,H,W,Cin], w [KH,KW,Cin,Cout] (HWIO)
    -> epilogue(conv(x, w) + b) [B, OH, OW, Cout].  A plan op that fuses
    the squash (``plan_op.fuses_squash``) forces the squash epilogue;
    callers supply ``squash_dim``."""
    kh, kw, cin, cout = w.shape
    oh = out_size(x.shape[1], kh, stride)
    ow = out_size(x.shape[2], kw, stride)
    m, k = x.shape[0] * oh * ow, kh * kw * cin
    if plan_op is not None:
        bm, bk, bn = (plan_op.block.block_m, plan_op.block.block_k,
                      plan_op.block.block_n)
        if plan_op.fuses_squash:
            epilogue = "squash"
    else:
        bm, bk, bn = planned_conv_blocks(
            m, k, cout, squash_dim if epilogue == "squash" else 0)
    patches = im2col_patches(x, kh=kh, kw=kw, stride=stride)
    out = matmul_bias_act(patches.reshape(m, k), w.reshape(k, cout), b,
                          block_m=bm, block_k=bk, block_n=bn,
                          epilogue=epilogue, squash_dim=squash_dim)
    return out.reshape(x.shape[0], oh, ow, cout)


@functools.lru_cache(maxsize=64)
def planned_votes_routing(num_caps: int, caps_dim: int, jd: int,
                          num_classes: int, iters: int) -> tuple[str, int]:
    """Memoized (mode, block_i) decision for ``votes_routing``."""
    sched = execplan.plan_votes_routing(num_caps, caps_dim, jd, num_classes,
                                        iters=iters)
    return sched.mode, sched.block_i


def votes_routing(u: torch.Tensor, w: torch.Tensor, *, plan=None,
                  op_name: str | None = None, iters: int | None = None,
                  num_classes: int | None = None) -> torch.Tensor:
    """u: [B, I, C], w: [I, J*D, C] -> v: [B, J*D].  The schedule comes
    from ``plan.op(op_name)`` (default ``"ClassCaps-Routing"``, the final
    layer) or the memoized plan decision."""
    op_name = op_name or execplan.FUSED_NAME
    if iters is None:
        iters = plan.cfg.routing_iters if plan is not None else 3
    if num_classes is None:
        num_classes = plan.cfg.num_classes if plan is not None else 10
    if plan is not None:
        op = plan.op(op_name)
        mode, block_i = op.mode, op.block_i
    else:
        mode, block_i = planned_votes_routing(u.shape[1], u.shape[2],
                                              w.shape[1], num_classes, iters)
    return _votes_routing(u, w, iters=iters, num_classes=num_classes,
                          mode=mode, block_i=block_i)


@functools.lru_cache(maxsize=64)
def planned_primary_routing(p_pos: int, k_in: int, n_ch: int, num_caps: int,
                            caps_dim: int, jd: int, num_classes: int,
                            iters: int) -> tuple[str, int, int]:
    """Memoized (mode, block_i, block_k) decision for ``primary_routing``."""
    sched = execplan.plan_primary_routing(p_pos, k_in, n_ch, num_caps,
                                          caps_dim, jd, num_classes,
                                          iters=iters)
    return sched.mode, sched.block_i, sched.block_k


def primary_routing(x: torch.Tensor, w_pc: torch.Tensor, b_pc: torch.Tensor,
                    w_cc: torch.Tensor, *, plan=None,
                    stride: int | None = None, iters: int | None = None,
                    num_classes: int | None = None) -> torch.Tensor:
    """Pipelined PrimaryCaps conv + votes/routing as ONE kernel: x is the
    Conv1 output [B, H, W, Cin], w_pc/b_pc the PrimaryCaps conv params,
    w_cc [I, J*D, C] the routing weights -> v [B, J*D].  The schedule
    comes from ``plan.op("PrimaryCaps-Routing")`` or the memoized plan
    decision."""
    if stride is None:
        stride = plan.cfg.pc_stride if plan is not None else 2
    if iters is None:
        iters = plan.cfg.routing_iters if plan is not None else 3
    if num_classes is None:
        num_classes = plan.cfg.num_classes if plan is not None else 10
    if plan is not None:
        op = plan.op(execplan.PIPE_NAME)
        mode, block_i, block_k = op.mode, op.block_i, op.block_k
    else:
        kh, kw, cin, n_ch = w_pc.shape
        oh = out_size(x.shape[1], kh, stride)
        ow = out_size(x.shape[2], kw, stride)
        num_caps, jd, caps_dim = w_cc.shape
        mode, block_i, block_k = planned_primary_routing(
            oh * ow, kh * kw * cin, n_ch, num_caps, caps_dim, jd,
            num_classes, iters)
    return _primary_routing(x, w_pc, b_pc, w_cc, stride=stride, iters=iters,
                            num_classes=num_classes, mode=mode,
                            block_i=block_i, block_k=block_k)
