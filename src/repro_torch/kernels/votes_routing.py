"""Fused ClassCaps votes + routing (K3 resident / K4 streamed) and its
backward (K8 resident / K9 streamed).

The counterpart of ``repro/kernels/votes_routing.py``: the forward
(``_resident_kernel`` / ``_streamed_kernel`` through ``_vr_apply``) and
the custom VJP's backward (``_resident_bwd_kernel`` /
``_streamed_bwd_kernel`` through ``_vr_grad``).  ``votes_routing`` is a
``torch.autograd.Function``: forward ``votes_routing_plain`` for CPU
tensors and the CUDA kernel (``csrc/votes_routing.cu``, one CTA per
sample) for CUDA tensors; backward ``votes_routing_bwd``, whose plain
twin and CUDA kernels (``csrc/votes_routing_bwd.cu``) compute the
reference's stop-gradient routing VJP by one explicit formula.  The plain
twins follow the kernels' schedule math: the i axis is zero-padded to a
multiple of ``block_i``; ``resident`` computes the votes once and
iterates on them; ``streamed`` recomputes each votes block on every pass
and folds the logits update of iteration ``t`` into the same pass as the
accumulation of ``s_t``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core import execplan
from repro_torch.core.execplan import (FUSED_NAME, MODES,
                                       routing_bwd_emit_smem,
                                       votes_routing_bwd_smem,
                                       votes_routing_smem)
from repro_torch.core.planner import SMEM_BYTES
from repro_torch.kernels import ref
from repro_torch.kernels.build import Kernel, on_cpu, ptr, stream_of

_P, _I = ctypes.c_void_p, ctypes.c_int
VOTES_ROUTING = Kernel("votes_routing", "votes_routing_f32",
                       [_P] * 3 + [_I] * 9 + [_P])
_BWD_ARGS = [_P] * 8 + [_I] * 9 + [_P]
ROUTING_BWD = {
    "resident": Kernel("votes_routing_bwd", "routing_bwd_resident_f32",
                       _BWD_ARGS),                                    # K8
    "streamed": Kernel("votes_routing_bwd", "routing_bwd_streamed_f32",
                       _BWD_ARGS),                                    # K9
}


def _votes_block(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """u: [B, TI, C], w: [TI, N, C] -> u_hat block [B, TI, N]."""
    return torch.einsum("bic,inc->bin", u, w)


def _padded(u: torch.Tensor, w: torch.Tensor, block_i: int):
    """Zero-pad the capsule axis to a multiple of ``block_i``: zero rows
    add nothing to s and leave the real capsules untouched."""
    i_dim = u.shape[1]
    n_blocks = -(-i_dim // block_i)
    pad = n_blocks * block_i - i_dim
    if pad:
        u = torch.nn.functional.pad(u, (0, 0, 0, pad))
        w = torch.nn.functional.pad(w, (0, 0, 0, 0, 0, pad))
    return u, w, n_blocks


def check_schedule(i_dim: int, jd: int, *, iters: int, num_classes: int,
                   mode: str, block_i: int) -> None:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; choose from {MODES}")
    if num_classes < 1 or jd % num_classes:
        raise ValueError(f"votes dim {jd} not divisible by classes "
                         f"{num_classes}")
    if iters < 1:
        raise ValueError(f"routing needs iters >= 1, got {iters}")
    if not 1 <= block_i <= i_dim:
        raise ValueError(f"block_i={block_i} outside [1, {i_dim}]")


def votes_routing_plain(u: torch.Tensor, w: torch.Tensor, *, iters: int,
                        num_classes: int, mode: str,
                        block_i: int) -> torch.Tensor:
    """The schedule both kernels run, in plain PyTorch: u [B, I, C],
    w [I, J*D, C] -> v [B, J*D]."""
    check_schedule(u.shape[1], w.shape[1], iters=iters,
                   num_classes=num_classes, mode=mode, block_i=block_i)
    bsz, _, _ = u.shape
    jd = w.shape[1]
    j, d = num_classes, jd // num_classes
    u, w, n_blocks = _padded(u, w, block_i)
    blocks = [slice(ib * block_i, (ib + 1) * block_i)
              for ib in range(n_blocks)]
    if mode == "resident":
        votes = torch.cat([_votes_block(u[:, r], w[r]) for r in blocks], 1)
        return ref.routing(votes.reshape(bsz, -1, j, d),
                           iters).reshape(bsz, jd)
    b = torch.zeros((bsz, u.shape[1], j), dtype=u.dtype, device=u.device)
    v = None
    for t in range(iters + 1):
        s = torch.zeros((bsz, j, d), dtype=u.dtype, device=u.device)
        for rows in blocks:
            uh4 = _votes_block(u[:, rows], w[rows]).reshape(bsz, -1, j, d)
            if t > 0:      # iteration t's logits update rides this W stream
                b[:, rows] += torch.einsum("bijd,bjd->bij", uh4, v)
            c = torch.softmax(b[:, rows], dim=2)
            s = s + torch.einsum("bij,bijd->bjd", c, uh4)
        v = ref.squash(s)
    return v.reshape(bsz, jd)


def _check_shapes(u: torch.Tensor, w: torch.Tensor) -> None:
    if u.dim() != 3 or w.dim() != 3 or w.shape[0] != u.shape[1] \
            or w.shape[2] != u.shape[2]:
        raise ValueError(f"votes_routing: u {tuple(u.shape)} and w "
                         f"{tuple(w.shape)} must be [B, I, C] and "
                         f"[I, J*D, C]")


def _check_smem(name: str, mode: str, smem: int) -> None:
    if smem > SMEM_BYTES:
        raise ValueError(f"{name}: the {mode} schedule needs {smem} B of "
                         f"shared memory per CTA, over {SMEM_BYTES} B")


def _forward(u: torch.Tensor, w: torch.Tensor, *, iters: int,
             num_classes: int, mode: str, block_i: int) -> torch.Tensor:
    """K3/K4 (or the plain twin on the CPU), not differentiable."""
    if on_cpu("votes_routing", u, w):
        return votes_routing_plain(u, w, iters=iters,
                                   num_classes=num_classes, mode=mode,
                                   block_i=block_i)
    bsz, i_dim, c = u.shape
    jd = w.shape[1]
    j = num_classes
    smem = votes_routing_smem(mode, i_dim, block_i, c, j, jd)
    _check_smem("votes_routing", mode, smem)
    out = torch.empty((bsz, jd), dtype=u.dtype, device=u.device)
    VOTES_ROUTING(ptr(u), ptr(w), ptr(out), bsz, i_dim, c, j, jd // j, iters,
                  int(mode == "resident"), block_i, smem, stream_of(u))
    return out


def votes_routing_bwd_plain(u: torch.Tensor, w: torch.Tensor,
                            g: torch.Tensor, *, iters: int, num_classes: int,
                            mode: str, block_i: int
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(du, dW) of ``votes_routing`` at output cotangent ``g [B, J*D]``,
    in the reference's stop-gradient convention, by the kernels' schedule.

    Replay the forward (``iters + 1`` passes), keeping ``b_{T-1}``,
    ``b_T``, ``s_{T-1}`` and ``s_T`` (T = iters); then, with ``c_t =
    softmax(b_t)``, one seed+reverse pass over the votes blocks::

        ds_T     = squash_vjp(s_T, g)
        db_T     = softmax_vjp(c_T, <u_hat, ds_T>)
        ds_{T-1} = squash_vjp(s_{T-1}, sum_i u_hat . db_T)

    and emit ``d u_hat = c_T (x) ds_T + c_{T-1} (x) ds_{T-1}`` contracted
    into ``du = d u_hat . W`` and ``dW = sum_b d u_hat (x) u``.  The
    logits updates are u_hat-constant, so nothing reaches further back
    than iteration T-1 (the reference's ``_streamed_bwd_tail``)."""
    check_schedule(u.shape[1], w.shape[1], iters=iters,
                   num_classes=num_classes, mode=mode, block_i=block_i)
    bsz, i_dim, _ = u.shape
    jd = w.shape[1]
    j, d = num_classes, jd // num_classes
    u_p, w_p, n_blocks = _padded(u, w, block_i)
    blocks = [slice(ib * block_i, (ib + 1) * block_i)
              for ib in range(n_blocks)]
    if mode == "resident":
        votes = torch.cat([_votes_block(u_p[:, r], w_p[r]) for r in blocks],
                          1).reshape(bsz, -1, j, d)

        def uh_of(rows):
            return votes[:, rows]
    else:
        def uh_of(rows):
            return _votes_block(u_p[:, rows], w_p[rows]).reshape(bsz, -1,
                                                                 j, d)
    b = torch.zeros((bsz, u_p.shape[1], j), dtype=u.dtype, device=u.device)
    b_prev = s_prev = v = None
    for t in range(iters + 1):
        if t == iters:
            b_prev = b.clone()
        s = torch.zeros((bsz, j, d), dtype=u.dtype, device=u.device)
        for rows in blocks:
            uh4 = uh_of(rows)
            if t > 0:
                b[:, rows] += torch.einsum("bijd,bjd->bij", uh4, v)
            c = torch.softmax(b[:, rows], dim=2)
            s = s + torch.einsum("bij,bijd->bjd", c, uh4)
        if t == iters - 1:
            s_prev = s
        v = ref.squash(s)
    ds_last = ref.squash_vjp(s, g.reshape(bsz, j, d))
    dv = torch.zeros((bsz, j, d), dtype=u.dtype, device=u.device)
    for rows in blocks:                     # seed + reverse in one pass
        uh4 = uh_of(rows)
        c = torch.softmax(b[:, rows], dim=2)
        db = ref.softmax_vjp(c, torch.einsum("bijd,bjd->bij", uh4, ds_last))
        dv = dv + torch.einsum("bijd,bij->bjd", uh4, db)
    ds_prev = ref.squash_vjp(s_prev, dv)
    duh = (torch.softmax(b, dim=2)[..., None] * ds_last[:, None]
           + torch.softmax(b_prev, dim=2)[..., None] * ds_prev[:, None]
           ).reshape(bsz, -1, jd)
    du = torch.einsum("bin,inc->bic", duh, w_p)[:, :i_dim]
    dw = torch.einsum("bin,bic->inc", duh, u_p)[:i_dim]
    return du, dw


def votes_routing_bwd(u: torch.Tensor, w: torch.Tensor, g: torch.Tensor, *,
                      iters: int = 3, num_classes: int = 10,
                      mode: str = "streamed", block_i: int = 128
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """K8 (``resident``) / K9 (``streamed``): (du [B, I, C], dW [I, J*D, C])
    of ``votes_routing`` at cotangent ``g [B, J*D]``.  On CUDA neither
    u_hat nor d u_hat reaches device memory: a per-sample replay writes
    only the logits ``b_{T-1}``, ``b_T`` and ``ds_{T-1}``, ``ds_T``; a
    per-capsule emit rebuilds d u_hat on chip and sums dW over the batch
    inside the CTA."""
    _check_shapes(u, w)
    bsz, i_dim, c = u.shape
    jd = w.shape[1]
    block_i = min(block_i, i_dim)
    check_schedule(i_dim, jd, iters=iters, num_classes=num_classes,
                   mode=mode, block_i=block_i)
    if g.shape != (bsz, jd):
        raise ValueError(f"votes_routing_bwd: cotangent {tuple(g.shape)}, "
                         f"expected {(bsz, jd)}")
    if on_cpu("votes_routing_bwd", u, w, g):
        return votes_routing_bwd_plain(u, w, g, iters=iters,
                                       num_classes=num_classes, mode=mode,
                                       block_i=block_i)
    j = num_classes
    smem = votes_routing_bwd_smem(mode, i_dim, block_i, c, j, jd)
    emit = routing_bwd_emit_smem(c, j, jd)
    _check_smem("votes_routing_bwd", mode, max(smem, emit))
    f32 = dict(dtype=u.dtype, device=u.device)
    logits = torch.empty((2, bsz, i_dim, j), **f32)      # b_{T-1}, b_T
    ds = torch.empty((2, bsz, jd), **f32)                # ds_{T-1}, ds_T
    du = torch.empty((bsz, i_dim, c), **f32)
    dw = torch.empty((i_dim, jd, c), **f32)
    ROUTING_BWD[mode](ptr(u), ptr(w), ptr(g), ptr(logits[0]),
                      ptr(logits[1]), ptr(ds), ptr(du), ptr(dw), bsz, i_dim,
                      c, j, jd // j, iters, block_i, smem, emit,
                      stream_of(u))
    return du, dw


@functools.lru_cache(maxsize=64)            # bounded like the plan caches
def planned_votes_routing_bwd(num_caps: int, caps_dim: int, jd: int,
                              num_classes: int, iters: int,
                              name: str = FUSED_NAME) -> tuple[str, int]:
    """Memoized (mode, block_i) decision for the routing backward; the
    planner's ``PlanError`` names the ``<name>-bwd`` op."""
    sched = execplan.plan_votes_routing_bwd(num_caps, caps_dim, jd,
                                            num_classes, iters=iters,
                                            name=name)
    return sched.mode, sched.block_i


class RoutingStatics(NamedTuple):
    """One votes+routing call: its forward schedule, and the backward's
    when the caller fixed it (``bwd_mode`` None: planned in backward)."""

    iters: int
    num_classes: int
    mode: str
    block_i: int
    bwd_mode: str | None
    bwd_block_i: int | None
    op_name: str


def routing_statics(i_dim: int, jd: int, *, iters: int, num_classes: int,
                    mode: str, block_i: int, bwd_mode: str | None,
                    bwd_block_i: int | None,
                    op_name: str = FUSED_NAME) -> RoutingStatics:
    """Clamp and check the forward schedule; the backward's is checked
    where it runs."""
    st = RoutingStatics(iters=iters, num_classes=num_classes, mode=mode,
                        block_i=min(block_i, i_dim), bwd_mode=bwd_mode,
                        bwd_block_i=bwd_block_i, op_name=op_name)
    check_schedule(i_dim, jd, iters=iters, num_classes=num_classes,
                   mode=st.mode, block_i=st.block_i)
    return st


def routing_bwd(u: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                st: RoutingStatics) -> tuple[torch.Tensor, torch.Tensor]:
    """``votes_routing_bwd`` on the caller's backward schedule, else on
    the planner's, chosen here so a forward without a backward (serving
    under ``no_grad``) never plans one."""
    if st.bwd_mode is not None:
        mode, block_i = st.bwd_mode, st.bwd_block_i or st.block_i
    else:
        mode, block_i = planned_votes_routing_bwd(
            u.shape[1], u.shape[2], w.shape[1], st.num_classes, st.iters,
            st.op_name)
    return votes_routing_bwd(u, w, g.contiguous(), iters=st.iters,
                             num_classes=st.num_classes, mode=mode,
                             block_i=block_i)


class _VotesRouting(torch.autograd.Function):
    """The reference's ``_vr_core`` custom VJP: saves ``(u, w)``; the
    backward recomputes the routing from them (K8/K9)."""

    @staticmethod
    def forward(ctx, u, w, st: RoutingStatics):
        ctx.st = st
        ctx.save_for_backward(u, w)
        return _forward(u, w, iters=st.iters, num_classes=st.num_classes,
                        mode=st.mode, block_i=st.block_i)

    @staticmethod
    def backward(ctx, g):
        u, w = ctx.saved_tensors
        du, dw = routing_bwd(u, w, g, ctx.st)
        need_u, need_w = ctx.needs_input_grad[:2]
        return (du if need_u else None), (dw if need_w else None), None


def votes_routing(u: torch.Tensor, w: torch.Tensor, *, iters: int = 3,
                  num_classes: int = 10, mode: str = "streamed",
                  block_i: int = 128, bwd_mode: str | None = None,
                  bwd_block_i: int | None = None,
                  op_name: str = FUSED_NAME) -> torch.Tensor:
    """K3/K4: u [B, I, C], w [I, J*D, C] -> v [B, J*D] (votes + routing,
    u_hat never leaves the chip on CUDA).  Differentiable: the backward
    runs ``votes_routing_bwd`` on ``bwd_mode`` / ``bwd_block_i`` (the
    i-tile defaulting to the forward's) when ``bwd_mode`` is given, else
    on the planner's backward schedule for ``op_name``."""
    _check_shapes(u, w)
    st = routing_statics(u.shape[1], w.shape[1], iters=iters,
                         num_classes=num_classes, mode=mode, block_i=block_i,
                         bwd_mode=bwd_mode, bwd_block_i=bwd_block_i,
                         op_name=op_name)
    return _VotesRouting.apply(u, w, st)
