"""Fused ClassCaps votes + routing (K3 resident / K4 streamed, K13 the
unfused oracle), its backward (K8 resident / K9 streamed / K13), and the
reversible residual segment K12.

The counterpart of ``repro/kernels/votes_routing.py``: the forward
(``_resident_kernel`` / ``_streamed_kernel`` / ``_streamed_2pass_kernel``
through ``_vr_apply``, with the optional residual-add epilogue), the
custom VJP's backward (``_resident_bwd_kernel`` / ``_streamed_bwd_kernel``
/ ``_streamed_2pass_bwd_kernel`` through ``_vr_grad``), and
``res_caps_segment`` (``_res_segment``).  ``votes_routing`` is a
``torch.autograd.Function``: forward the plain twins for CPU tensors and
the CUDA kernels (``csrc/votes_routing.cu``) for CUDA tensors; backward
``votes_routing_bwd``, whose plain twin and CUDA kernels
(``csrc/votes_routing_bwd.cu``) compute the reference's stop-gradient
routing VJP by one explicit formula.  Every kernel routes each sample on
a thread-block cluster, at the planner's size where the caller names
none: it sums s rank by rank over each CTA's rows and adds the partials
in rank order (``cluster_routing_plain``, ``votes_routing_bwd_plain``,
over ``cluster_plain.replay``).  ``resident`` computes each CTA's rows'
votes once, ``streamed`` folds the logits update of iteration ``t`` into
the same pass as the accumulation of ``s_t``, ``block_i`` rows at a time
(the kernel recomputes each votes block on every pass; its twin computes
them once, which gives the same values), and ``streamed-global`` is
``streamed`` with the logits in device memory (the same twin).
``streamed-2pass`` (K13, the oracle) is ``streamed`` with a b-pass and
then an s-pass per iteration, on K4's (K9's) cluster and with its logits
where K4 keeps them: the same sums in the same order, so its output and
gradients equal the fused kernels' bit for bit.  ``votes_routing_plain``
keeps the one-CTA orders: the reference's for ``resident``, one CTA's
fused passes (``routing.routing_plain`` at one rank) for the streamed
modes, and the reference's two-pass order (the i axis zero-padded to a
multiple of ``block_i``) for ``streamed-2pass``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core import execplan
from repro_torch.core.execplan import MODES  # noqa: F401  (re-exported)
from repro_torch.core.execplan import (ALL_MODES, CLUSTER_SIZES, FUSED_NAME,
                                       ORACLE_MODE, STREAMED_GLOBAL,
                                       routing_bwd_cluster_smem,
                                       routing_bwd_emit_smem,
                                       votes_routing_cluster_smem)
from repro_torch.core.planner import SMEM_BYTES
from repro_torch.kernels import build, ref
from repro_torch.kernels.build import (Kernel, cluster_query, on_cpu, ptr,
                                       stream_of)
from repro_torch.kernels.cluster_plain import cluster_spans  # noqa: F401
from repro_torch.kernels.cluster_plain import rank_blocks, replay
from repro_torch.kernels.routing import routing_plain

_P, _I = ctypes.c_void_p, ctypes.c_int
# Each sample on a thread-block cluster: K3 (resident votes), K4 (streamed),
# K4g (streamed, the logits in global memory) and K13 (K4 on the unfused
# schedule, its logits in shared or global memory), one kernel.
VOTES_ROUTING_2PASS = Kernel("votes_routing", "votes_routing_2pass_f32",
                             [_P] * 5 + [_I] * 9 + [_P])              # K13
VOTES_ROUTING_CLUSTER = Kernel("votes_routing", "votes_routing_cluster_f32",
                               [_P] * 4 + [_I] * 8 + [_P])
VOTES_ROUTING_STREAMED = Kernel("votes_routing",
                                "votes_routing_streamed_cluster_f32",
                                [_P] * 4 + [_I] * 9 + [_P])
VOTES_ROUTING_GLOBAL = Kernel("votes_routing",
                              "votes_routing_global_cluster_f32",
                              [_P] * 5 + [_I] * 9 + [_P])
ROUTING_BWD_2PASS = Kernel("votes_routing_bwd", "routing_bwd_2pass_f32",
                           [_P] * 8 + [_I] * 10 + [_P])               # K13
# K8 (resident votes), K9 (streamed) and K13 (K9 on the unfused schedule):
# the replay on a thread-block cluster per sample, then the emit.
ROUTING_BWD_CLUSTER = Kernel("votes_routing_bwd", "routing_bwd_cluster_f32",
                             [_P] * 8 + [_I] * 11 + [_P])


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
    if mode not in ALL_MODES:
        raise ValueError(f"unknown mode {mode!r}; choose from {ALL_MODES}")
    if num_classes < 1 or jd % num_classes:
        raise ValueError(f"votes dim {jd} not divisible by classes "
                         f"{num_classes}")
    if iters < 1:
        raise ValueError(f"routing needs iters >= 1, got {iters}")
    if not 1 <= block_i <= i_dim:
        raise ValueError(f"block_i={block_i} outside [1, {i_dim}]")


def routing_2pass_plain(u_hat: torch.Tensor, *, iters: int,
                        num_classes: int, block_i: int) -> torch.Tensor:
    """K13's schedule over votes u_hat [B, I, J*D] -> v [B, J*D]: each
    iteration ``t > 0`` first runs a b-pass (the logits update, block by
    block), then an s-pass of its own."""
    bsz, i_dim, jd = u_hat.shape
    j, d = num_classes, jd // num_classes
    uh4 = u_hat.reshape(bsz, i_dim, j, d)
    blocks = [slice(i0, i0 + block_i) for i0 in range(0, i_dim, block_i)]
    b = torch.zeros((bsz, i_dim, j), dtype=u_hat.dtype, device=u_hat.device)
    v = None
    for t in range(iters + 1):
        if t > 0:
            for rows in blocks:
                b[:, rows] += torch.einsum("bijd,bjd->bij", uh4[:, rows], v)
        s = torch.zeros((bsz, j, d), dtype=u_hat.dtype, device=u_hat.device)
        for rows in blocks:
            c = torch.softmax(b[:, rows], dim=2)
            s = s + torch.einsum("bij,bijd->bjd", c, uh4[:, rows])
        v = ref.squash(s)
    return v.reshape(bsz, jd)


def votes_routing_plain(u: torch.Tensor, w: torch.Tensor, *, iters: int,
                        num_classes: int, mode: str, block_i: int,
                        r: torch.Tensor | None = None) -> torch.Tensor:
    """The one-CTA orders in plain PyTorch (K13's own, one CTA's fused
    passes for the streamed modes, ``resident`` in the reference's order;
    the cluster kernels' twin is ``cluster_routing_plain``): u [B, I, C],
    w [I, J*D, C] -> v [B, J*D], plus the residual ``r [B, J*D]`` when
    given (the epilogue: v itself is never changed)."""
    check_schedule(u.shape[1], w.shape[1], iters=iters,
                   num_classes=num_classes, mode=mode, block_i=block_i)
    bsz, _, _ = u.shape
    jd = w.shape[1]
    j, d = num_classes, jd // num_classes
    u, w, n_blocks = _padded(u, w, block_i)
    votes = torch.cat([_votes_block(u[:, ib * block_i:(ib + 1) * block_i],
                                    w[ib * block_i:(ib + 1) * block_i])
                       for ib in range(n_blocks)], 1)
    if mode == "resident":
        v = ref.routing(votes.reshape(bsz, -1, j, d), iters).reshape(bsz, jd)
    elif mode == ORACLE_MODE:
        v = routing_2pass_plain(votes, iters=iters, num_classes=j,
                                block_i=block_i)
    else:
        # A recomputed votes block equals the one computed here, so the
        # streamed schedule (wherever its logits live) is the split
        # routing's fused s+b passes over them.
        v = routing_plain(votes, iters=iters, num_classes=j,
                          block_i=block_i)
    return v if r is None else v + r


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


@functools.lru_cache(maxsize=64)            # the batch is a key: bounded
def planned_cluster(num_caps: int, caps_dim: int, jd: int, num_classes: int,
                    iters: int, batch: int, mode: str = "resident",
                    block_i: int | None = None) -> int:
    """The planner's K3/K4 cluster size at ``batch`` for ``mode``'s
    placement of the votes and logits (at the i-tile ``block_i`` when
    given); the oracle K13 takes K4's: streamed, else streamed-global."""
    for votes in (("streamed", STREAMED_GLOBAL) if mode == ORACLE_MODE
                  else (mode,)):
        sched = execplan.plan_votes_routing_cluster(
            num_caps, caps_dim, jd, num_classes, iters=iters, batch=batch,
            votes=votes, block_i=block_i)
        if sched is not None:
            return sched.cluster.cluster
    raise ValueError(f"votes_routing: no cluster of {CLUSTER_SIZES} CTAs "
                     f"holds the {mode} votes of {num_caps} capsules of "
                     f"{caps_dim}D -> {jd}")


def fwd_cluster(u: torch.Tensor, w: torch.Tensor, *, iters: int,
                num_classes: int, mode: str, cluster: int | None,
                block_i: int | None = None) -> int:
    """The forward's cluster size: every mode runs on K3/K4's cluster (the
    planner's size at this batch for the mode and i-tile unless
    ``cluster`` names one; the oracle K13 K4's, ``planned_cluster``)."""
    if cluster is None:
        return planned_cluster(u.shape[1], u.shape[2], w.shape[1],
                               num_classes, iters, u.shape[0], mode,
                               None if mode == "resident" else block_i)
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"votes_routing: a cluster of {cluster} CTAs; "
                         f"clusters are {CLUSTER_SIZES} CTAs")
    return cluster


# The cluster kernel's C entry for each mode.
_CLUSTER_ENTRY = {"resident": VOTES_ROUTING_CLUSTER,
                  "streamed": VOTES_ROUTING_STREAMED,
                  STREAMED_GLOBAL: VOTES_ROUTING_GLOBAL,
                  ORACLE_MODE: VOTES_ROUTING_2PASS}


def logits_placement(mode: str, i_dim: int, caps_dim: int, num_classes: int,
                     jd: int, cluster: int, block_i: int) -> str:
    """Where a forward CTA keeps its rows' logits: ``mode``'s placement,
    and for the oracle K13 K4's at this cluster size and i-tile (shared
    memory where ``streamed`` fits a CTA, else ``streamed-global``)."""
    if mode != ORACLE_MODE:
        return mode
    smem = votes_routing_cluster_smem(i_dim, caps_dim, num_classes, jd,
                                      cluster, mode="streamed",
                                      block_i=block_i)
    return "streamed" if smem <= SMEM_BYTES else STREAMED_GLOBAL


def _forward(u: torch.Tensor, w: torch.Tensor, r: torch.Tensor | None, *,
             iters: int, num_classes: int, mode: str, block_i: int,
             cluster: int | None = None) -> torch.Tensor:
    """K3/K4/K13, each sample on a cluster of ``cluster`` CTAs (its votes
    and logits placed by ``mode``), or the plain twin on the CPU; not
    differentiable; adds ``r [B, J*D]`` to the output when given.  A
    refused cluster launch raises, naming its grid and shared memory;
    nothing falls back."""
    bsz, i_dim, c = u.shape
    jd = w.shape[1]
    if r is not None and r.shape != (bsz, jd):
        raise ValueError(f"votes_routing: residual {tuple(r.shape)}, "
                         f"expected {(bsz, jd)}")
    cluster = fwd_cluster(u, w, iters=iters, num_classes=num_classes,
                          mode=mode, cluster=cluster, block_i=block_i)
    extra = () if r is None else (r,)
    if on_cpu("votes_routing", u, w, *extra):
        return cluster_routing_plain(u, w, iters=iters,
                                     num_classes=num_classes, mode=mode,
                                     block_i=block_i, cluster=cluster, r=r)
    j = num_classes
    f32 = dict(dtype=u.dtype, device=u.device)
    out = torch.empty((bsz, jd), **f32)
    place = logits_placement(mode, i_dim, c, j, jd, cluster, block_i)
    smem = votes_routing_cluster_smem(i_dim, c, j, jd, cluster, mode=place,
                                      block_i=block_i)
    _check_smem("votes_routing", f"{mode} {cluster}-CTA cluster", smem)
    # The logits scratch [B, I, J] where they are in global memory (null
    # for K13 where they are not): written and read by the kernel alone.
    logits = (torch.empty((bsz, i_dim, j), **f32)
              if place == STREAMED_GLOBAL else None)
    scratch = ([] if mode in ("resident", "streamed")
               else [None if logits is None else ptr(logits)])
    tile = [] if mode == "resident" else [block_i]
    try:
        _CLUSTER_ENTRY[mode](ptr(u), ptr(w),
                             ptr(r) if r is not None else None, *scratch,
                             ptr(out), bsz, i_dim, c, j, jd // j, iters,
                             *tile, cluster, smem, stream_of(u))
    except RuntimeError as err:
        raise RuntimeError(
            f"votes_routing: the launch of {bsz} clusters of {cluster} "
            f"CTAs ({smem} B of shared memory each) was refused: "
            f"{err}") from err
    return out


def cluster_routing_plain(u: torch.Tensor, w: torch.Tensor, *, iters: int,
                          num_classes: int, mode: str, block_i: int,
                          cluster: int,
                          r: torch.Tensor | None = None) -> torch.Tensor:
    """The cluster schedule's forward (``csrc/routing_cluster.cuh``) in
    plain PyTorch: u [B, I, C], w [I, J*D, C] -> v [B, J*D] (+ ``r [B,
    J*D]`` when given), each of the ``cluster`` ranks summing s over its
    block of rows (``cluster_spans``; ``block_i`` rows at a time unless
    ``mode`` is resident), the partials added in rank order; under
    ``streamed-2pass`` (K13) each pass after the first a b-pass and an
    s-pass.  Every placement of the logits (``streamed-global`` too) does
    the same arithmetic."""
    bsz, i_dim, _ = u.shape
    jd = w.shape[1]
    j, d = num_classes, jd // num_classes
    votes = _votes_block(u, w).reshape(bsz, i_dim, j, d)
    b = u.new_zeros((bsz, i_dim, j))
    _, _, s = replay(lambda rows: votes[:, rows],
                     rank_blocks(i_dim, block_i, cluster, mode == "resident"),
                     b, (bsz, j, d), iters=iters,
                     two_pass=mode == ORACLE_MODE)
    v = ref.squash(s).reshape(bsz, jd)
    return v if r is None else v + r


@functools.lru_cache(maxsize=64)            # the batch is a key: bounded
def planned_bwd_cluster(num_caps: int, caps_dim: int, jd: int,
                        num_classes: int, iters: int, batch: int,
                        votes: str) -> int:
    """The planner's K8/K9 cluster size at ``batch`` for ``votes``
    (``resident`` or ``streamed``; the oracle K13 takes K9's,
    ``streamed``)."""
    sched = execplan.plan_routing_bwd_cluster(
        num_caps, caps_dim, jd, num_classes, iters=iters, batch=batch,
        votes="streamed" if votes == ORACLE_MODE else votes)
    if sched is None:
        raise ValueError(f"votes_routing_bwd: no cluster of "
                         f"{CLUSTER_SIZES} CTAs fits {num_caps} capsules of "
                         f"{caps_dim}D -> {jd} with {votes} votes")
    return sched.cluster.cluster


def bwd_schedule(u: torch.Tensor, w: torch.Tensor, *, iters: int,
                 num_classes: int, mode: str,
                 cluster: int | None) -> tuple[str, int]:
    """The backward's ``(mode, cluster)``: resident (K8), streamed (K9)
    and the oracle (K13, K9's streamed votes on the unfused schedule) run
    on a cluster, whose CTAs keep their rows' logits on chip, so
    ``streamed-global`` is ``streamed`` there, and without ``cluster``
    they take the planner's size at this batch."""
    if mode == STREAMED_GLOBAL:
        mode = "streamed"
    if cluster is None:
        cluster = planned_bwd_cluster(u.shape[1], u.shape[2], w.shape[1],
                                      num_classes, iters, u.shape[0], mode)
    return mode, cluster


def votes_routing_bwd_plain(u: torch.Tensor, w: torch.Tensor,
                            g: torch.Tensor, *, iters: int, num_classes: int,
                            mode: str, block_i: int,
                            cluster: int | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """(du, dW) of ``votes_routing`` at output cotangent ``g [B, J*D]``,
    in the reference's stop-gradient convention, by the kernels' schedule
    (``bwd_schedule``): a cluster of ``cluster`` CTAs, whose ``mode``
    places each CTA's votes (K8 resident, K9 and K13 streamed).

    Replay the forward (``iters + 1`` passes; under ``streamed-2pass`` a
    b-pass before each s-pass after the first), keeping ``b_{T-1}``,
    ``b_T``, ``s_{T-1}`` and ``s_T`` (T = iters); then, with ``c_t =
    softmax(b_t)``, one seed+reverse pass over the votes blocks::

        ds_T     = squash_vjp(s_T, g)
        db_T     = softmax_vjp(c_T, <u_hat, ds_T>)
        ds_{T-1} = squash_vjp(s_{T-1}, sum_i u_hat . db_T)

    and emit ``d u_hat = c_T (x) ds_T + c_{T-1} (x) ds_{T-1}`` contracted
    into ``du = d u_hat . W`` and ``dW = sum_b d u_hat (x) u``.  The
    logits updates are u_hat-constant, so nothing reaches further back
    than iteration T-1 (the reference's ``_streamed_bwd_tail``).  Sums
    over rows (s, and the reverse pass's dv) are taken rank by rank and
    the partials added in rank order, as the cluster reduces them."""
    check_schedule(u.shape[1], w.shape[1], iters=iters,
                   num_classes=num_classes, mode=mode, block_i=block_i)
    mode, cluster = bwd_schedule(u, w, iters=iters, num_classes=num_classes,
                                 mode=mode, cluster=cluster)
    bsz, i_dim, _ = u.shape
    jd = w.shape[1]
    j, d = num_classes, jd // num_classes
    ranks = rank_blocks(i_dim, block_i, cluster, mode == "resident")
    if mode == "resident":
        votes = _votes_block(u, w).reshape(bsz, -1, j, d)

        def uh_of(rows):
            return votes[:, rows]
    else:
        def uh_of(rows):
            return _votes_block(u[:, rows], w[rows]).reshape(bsz, -1, j, d)
    b = torch.zeros((bsz, i_dim, j), dtype=u.dtype, device=u.device)
    b_prev, s_prev, s = replay(uh_of, ranks, b, (bsz, j, d), iters=iters,
                               two_pass=mode == ORACLE_MODE)
    ds_last = ref.squash_vjp(s, g.reshape(bsz, j, d))
    dv = torch.zeros((bsz, j, d), dtype=u.dtype, device=u.device)
    for rk in ranks:                        # seed + reverse in one pass
        part = torch.zeros_like(dv)
        for rows in rk:
            uh4 = uh_of(rows)
            c = torch.softmax(b[:, rows], dim=2)
            db = ref.softmax_vjp(c, torch.einsum("bijd,bjd->bij", uh4,
                                                 ds_last))
            part = part + torch.einsum("bijd,bij->bjd", uh4, db)
        dv = dv + part
    ds_prev = ref.squash_vjp(s_prev, dv)
    duh = (torch.softmax(b, dim=2)[..., None] * ds_last[:, None]
           + torch.softmax(b_prev, dim=2)[..., None] * ds_prev[:, None]
           ).reshape(bsz, -1, jd)
    du = torch.einsum("bin,inc->bic", duh, w)
    dw = torch.einsum("bin,bic->inc", duh, u)
    return du, dw


def votes_routing_bwd(u: torch.Tensor, w: torch.Tensor, g: torch.Tensor, *,
                      iters: int = 3, num_classes: int = 10,
                      mode: str = "streamed", block_i: int = 128,
                      cluster: int | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """(du [B, I, C], dW [I, J*D, C]) of ``votes_routing`` at cotangent
    ``g [B, J*D]``.  K8 and K9 replay each sample on a cluster of
    ``cluster`` CTAs, their votes ``resident`` (K8) or ``streamed`` (K9,
    also for ``streamed-global``) as ``mode`` says; without ``cluster``
    the planner's size at this batch (``bwd_schedule``).
    ``streamed-2pass`` is K13: K9's replay on the unfused schedule.  On
    CUDA neither u_hat nor d u_hat reaches device memory: the replay
    writes only the logits ``b_{T-1}``, ``b_T`` and ``ds_{T-1}``,
    ``ds_T``; a per-capsule emit rebuilds d u_hat on chip and sums dW
    over the batch inside the CTA.  A refused cluster launch raises;
    nothing falls back."""
    _check_shapes(u, w)
    bsz, i_dim, c = u.shape
    jd = w.shape[1]
    block_i = min(block_i, i_dim)
    check_schedule(i_dim, jd, iters=iters, num_classes=num_classes,
                   mode=mode, block_i=block_i)
    if cluster is not None and cluster not in CLUSTER_SIZES:
        raise ValueError(f"votes_routing_bwd: a cluster of {cluster} CTAs; "
                         f"clusters are {CLUSTER_SIZES} CTAs")
    mode, cluster = bwd_schedule(u, w, iters=iters, num_classes=num_classes,
                                 mode=mode, cluster=cluster)
    if g.shape != (bsz, jd):
        raise ValueError(f"votes_routing_bwd: cotangent {tuple(g.shape)}, "
                         f"expected {(bsz, jd)}")
    if on_cpu("votes_routing_bwd", u, w, g):
        return votes_routing_bwd_plain(u, w, g, iters=iters,
                                       num_classes=num_classes, mode=mode,
                                       block_i=block_i, cluster=cluster)
    j = num_classes
    resident = mode == "resident"
    smem = routing_bwd_cluster_smem("resident" if resident else "streamed",
                                    i_dim, block_i, c, j, jd, cluster)
    emit = routing_bwd_emit_smem(c, j, jd)
    _check_smem("votes_routing_bwd", mode, max(smem, emit))
    f32 = dict(dtype=u.dtype, device=u.device)
    logits = torch.empty((2, bsz, i_dim, j), **f32)      # b_{T-1}, b_T
    ds = torch.empty((2, bsz, jd), **f32)                # ds_{T-1}, ds_T
    du = torch.empty((bsz, i_dim, c), **f32)
    dw = torch.empty((i_dim, jd, c), **f32)
    entry, votes = ((ROUTING_BWD_2PASS, []) if mode == ORACLE_MODE
                    else (ROUTING_BWD_CLUSTER, [int(resident)]))
    try:
        entry(ptr(u), ptr(w), ptr(g), ptr(logits[0]), ptr(logits[1]),
              ptr(ds), ptr(du), ptr(dw), bsz, i_dim, c, j, jd // j, iters,
              *votes, block_i, cluster, smem, emit, stream_of(u))
    except RuntimeError as err:
        raise RuntimeError(
            f"votes_routing_bwd: the launch of {bsz} clusters of "
            f"{cluster} CTAs ({smem} B of shared memory each) was "
            f"refused: {err}") from err
    return du, dw


def cluster_occupancy(i_dim: int, caps_dim: int, num_classes: int,
                      out_dim: int, *, cluster: int, mode: str = "resident",
                      block_i: int = 1) -> dict[str, int]:
    """On the card: how many K3/K4 clusters of ``cluster`` CTAs with
    ``mode``'s placement run at once, and the kernel's attributes
    (``build.cluster_query``)."""
    return cluster_query("votes_routing", "votes_routing_cluster_occupancy",
                         i_dim, caps_dim, num_classes, out_dim, cluster,
                         int(mode == "resident"), block_i,
                         int(mode == STREAMED_GLOBAL))


def empty_launch(bsz: int, cluster: int, smem: int,
                 device: torch.device) -> None:
    """On the card: an empty kernel on ``bsz`` clusters of ``cluster`` CTAs
    with ``smem`` bytes of shared memory each, on the current stream --
    the floor under a cluster launch of that shape (a measurement aid,
    on no model path and counted nowhere)."""
    build.call("votes_routing", "empty_cluster_launch", [_I] * 3 + [_P],
               bsz, cluster, smem,
               ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))


def bwd_cluster_occupancy(i_dim: int, caps_dim: int, num_classes: int,
                          out_dim: int, *, mode: str, block_i: int,
                          cluster: int) -> dict[str, int]:
    """On the card: how many K8/K9 replay clusters of this schedule run at
    once, and the kernel's attributes (``build.cluster_query``)."""
    return cluster_query("votes_routing_bwd",
                         "routing_bwd_cluster_occupancy", i_dim, caps_dim,
                         num_classes, out_dim, cluster,
                         int(mode == "resident"), block_i)


@functools.lru_cache(maxsize=64)            # bounded like the plan caches
def planned_votes_routing_bwd(num_caps: int, caps_dim: int, jd: int,
                              num_classes: int, iters: int,
                              name: str = FUSED_NAME, batch: int = 1
                              ) -> tuple[str, int, int | None]:
    """Memoized (mode, block_i, cluster) decision for the routing
    backward at ``batch``; the planner's ``PlanError`` names the
    ``<name>-bwd`` op."""
    sched = execplan.plan_votes_routing_bwd(num_caps, caps_dim, jd,
                                            num_classes, iters=iters,
                                            batch=batch, name=name)
    return (sched.mode, sched.block_i,
            sched.cluster.cluster if sched.cluster else None)


class RoutingStatics(NamedTuple):
    """One votes+routing call: its forward schedule (``cluster`` None: the
    planner's K3/K4 size at the call's batch), and the
    backward's when the caller fixed it (``bwd_mode`` None: planned in
    backward)."""

    iters: int
    num_classes: int
    mode: str
    block_i: int
    bwd_mode: str | None
    bwd_block_i: int | None
    op_name: str = FUSED_NAME
    bwd_cluster: int | None = None
    cluster: int | None = None


def routing_statics(i_dim: int, jd: int, *, iters: int, num_classes: int,
                    mode: str, block_i: int, bwd_mode: str | None,
                    bwd_block_i: int | None, op_name: str = FUSED_NAME,
                    bwd_cluster: int | None = None,
                    cluster: int | None = None) -> RoutingStatics:
    """Clamp and check the forward schedule; the backward's is checked
    where it runs."""
    st = RoutingStatics(iters=iters, num_classes=num_classes, mode=mode,
                        block_i=min(block_i, i_dim), bwd_mode=bwd_mode,
                        bwd_block_i=bwd_block_i, op_name=op_name,
                        bwd_cluster=bwd_cluster, cluster=cluster)
    check_schedule(i_dim, jd, iters=iters, num_classes=num_classes,
                   mode=st.mode, block_i=st.block_i)
    return st


def routing_bwd(u: torch.Tensor, w: torch.Tensor, g: torch.Tensor,
                st: RoutingStatics) -> tuple[torch.Tensor, torch.Tensor]:
    """``votes_routing_bwd`` on the caller's backward schedule, else on
    the planner's at this batch, chosen here so a forward without a
    backward (serving under ``no_grad``) never plans one."""
    if st.bwd_mode is not None:
        mode, block_i, cluster = (st.bwd_mode, st.bwd_block_i or st.block_i,
                                  st.bwd_cluster)
    else:
        mode, block_i, cluster = planned_votes_routing_bwd(
            u.shape[1], u.shape[2], w.shape[1], st.num_classes, st.iters,
            st.op_name, u.shape[0])
    return votes_routing_bwd(u, w, g.contiguous(), iters=st.iters,
                             num_classes=st.num_classes, mode=mode,
                             block_i=block_i, cluster=cluster)


def _forward_st(u: torch.Tensor, w: torch.Tensor, st: RoutingStatics,
                r: torch.Tensor | None = None) -> torch.Tensor:
    return _forward(u, w, r, iters=st.iters, num_classes=st.num_classes,
                    mode=st.mode, block_i=st.block_i, cluster=st.cluster)


class _VotesRouting(torch.autograd.Function):
    """The reference's ``_vr_core`` custom VJP, and with a residual ``r``
    its ``_vr_core_res``: saves ``(u, w)``; the backward recomputes the
    routing from them (K8/K9, K13) and passes ``r``'s cotangent through
    (the add is linear)."""

    @staticmethod
    def forward(ctx, u, w, r, st: RoutingStatics):
        ctx.st = st
        ctx.save_for_backward(u, w)
        return _forward_st(u, w, st, r)

    @staticmethod
    def backward(ctx, g):
        u, w = ctx.saved_tensors
        du, dw = routing_bwd(u, w, g, ctx.st)
        need_u, need_w, need_r = ctx.needs_input_grad[:3]
        return ((du if need_u else None), (dw if need_w else None),
                (g if need_r else None), None)


def votes_routing(u: torch.Tensor, w: torch.Tensor, *,
                  r: torch.Tensor | None = None, iters: int = 3,
                  num_classes: int = 10, mode: str = "streamed",
                  block_i: int = 128, cluster: int | None = None,
                  bwd_mode: str | None = None,
                  bwd_block_i: int | None = None,
                  op_name: str = FUSED_NAME,
                  bwd_cluster: int | None = None) -> torch.Tensor:
    """K3 (``mode="resident"``), K4 (``streamed``, ``streamed-global``) or
    K13 (``mode="streamed-2pass"``, K4 on the unfused schedule), each
    sample on a cluster of ``cluster`` CTAs (None: the planner's size at
    this batch for the mode and ``block_i``): u [B, I, C], w [I, J*D, C]
    -> v [B, J*D] (votes + routing, u_hat never leaves the chip on CUDA),
    plus ``r [B, J*D]`` when given, added in the kernel's epilogue.
    Differentiable: the backward runs ``votes_routing_bwd`` on
    ``bwd_mode`` / ``bwd_block_i`` (the i-tile defaulting to the
    forward's) and ``bwd_cluster`` when ``bwd_mode`` is given, else on
    the planner's backward schedule for ``op_name``."""
    _check_shapes(u, w)
    st = routing_statics(u.shape[1], w.shape[1], iters=iters,
                         num_classes=num_classes, mode=mode, block_i=block_i,
                         bwd_mode=bwd_mode, bwd_block_i=bwd_block_i,
                         op_name=op_name, bwd_cluster=bwd_cluster,
                         cluster=cluster)
    return _VotesRouting.apply(u, w, r, st)


# ---------------------------------------------------------------------------
# Reversible residual capsule segment (K12)
# ---------------------------------------------------------------------------

def _res_segment_run(blocks, x: torch.Tensor, ws) -> torch.Tensor:
    """Forward walk of a run of additive-coupling blocks: for each block
    ``(i1, st_f, st_g)`` split the capsule axis at ``i1`` and apply
    ``y1 = x1 + F(x2)``, ``y2 = x2 + G(y1)``, each half one votes+routing
    kernel with the residual-add epilogue."""
    h = x
    for k, (i1, st_f, st_g) in enumerate(blocks):
        bsz = h.shape[0]
        x1, x2 = h[:, :i1].contiguous(), h[:, i1:].contiguous()
        y1 = _forward_st(x2, ws[2 * k], st_f,
                         x1.reshape(bsz, -1)).reshape(x1.shape)
        y2 = _forward_st(y1, ws[2 * k + 1], st_g,
                         x2.reshape(bsz, -1)).reshape(x2.shape)
        h = torch.cat([y1, y2], dim=1)
    return h


class ResCapsSegment(torch.autograd.Function):
    """K12, the reference's ``_res_segment`` custom VJP.

    The forward saves ONLY the segment output and the weights, never x
    or a per-block intermediate, so activation memory stays flat in
    depth.  The backward inverts the coupling block by block, last block
    first: it recomputes ``G(y1)`` and ``F(x2)`` (forward kernels without
    the epilogue, under ``no_grad``) to rebuild ``x2 = y2 - G(y1)`` and
    ``x1 = y1 - F(x2)``, then pushes the cotangents through the halves'
    backward kernels::

        d y1_total = g1 + dG/dy1^T g2,   d x1 = d y1_total,
        d x2       = g2 + dF/dx2^T d y1_total
    """

    @staticmethod
    def forward(ctx, x, blocks, *ws):
        y = _res_segment_run(blocks, x, ws)
        ctx.blocks = blocks
        ctx.save_for_backward(y, *ws)
        return y

    @staticmethod
    def backward(ctx, g):
        y, *ws = ctx.saved_tensors
        blocks = ctx.blocks
        bsz = y.shape[0]
        dws = [None] * len(ws)
        for k in range(len(blocks) - 1, -1, -1):
            i1, st_f, st_g = blocks[k]
            wf, wg = ws[2 * k], ws[2 * k + 1]
            y1, y2 = y[:, :i1].contiguous(), y[:, i1:].contiguous()
            g1 = g[:, :i1].reshape(bsz, -1)
            g2 = g[:, i1:].reshape(bsz, -1)
            with torch.no_grad():
                x2 = y2 - _forward_st(y1, wg, st_g).reshape(y2.shape)
                x1 = y1 - _forward_st(x2, wf, st_f).reshape(y1.shape)
            dy1_g, dwg = routing_bwd(y1, wg, g2, st_g)
            g1_tot = g1 + dy1_g.reshape(bsz, -1)
            dx2_f, dwf = routing_bwd(x2, wf, g1_tot, st_f)
            g = torch.cat([g1_tot.reshape(y1.shape),
                           g2.reshape(y2.shape) + dx2_f], dim=1)
            y = torch.cat([x1, x2], dim=1)
            dws[2 * k], dws[2 * k + 1] = dwf, dwg
        return (g, None, *dws)


def _seg_statics(stat, i_dim: int, jd: int) -> RoutingStatics:
    """One half's schedule -- a ``RoutingStatics`` or the reference's
    ``(iters, num_out_caps, mode, block_i, bwd_mode, bwd_block_i)`` --
    checked, with its i-tiles clamped to the half's ``i_dim``."""
    st = RoutingStatics(*stat)
    if st.mode not in ALL_MODES or (st.bwd_mode is not None
                                    and st.bwd_mode not in ALL_MODES):
        raise ValueError(f"unknown mode {st.mode!r}/{st.bwd_mode!r}; "
                         f"choose from {ALL_MODES}")
    bwd_bi = (None if st.bwd_block_i is None
              else max(1, min(st.bwd_block_i, i_dim)))
    return routing_statics(i_dim, jd, iters=st.iters,
                           num_classes=st.num_classes, mode=st.mode,
                           block_i=max(1, st.block_i), bwd_mode=st.bwd_mode,
                           bwd_block_i=bwd_bi, op_name=st.op_name,
                           bwd_cluster=st.bwd_cluster, cluster=st.cluster)


def res_caps_segment(x: torch.Tensor, ws, *, blocks) -> torch.Tensor:
    """x: [B, I, C] through a run of reversible ResCapsBlocks -> [B, I, C].

    ``blocks`` is a tuple of ``(i1, stats_f, stats_g)`` per block, where
    ``i1`` is the coupling split point and each ``stats`` is the half's
    schedule (see ``_seg_statics``; ``repro_torch.kernels.ops`` takes it
    from the plan).  ``ws`` are the flat per-half weights, F then G per
    block: ``wf [I-i1, i1*C, C]``, ``wg [i1, (I-i1)*C, C]``.
    Differentiable with no saved activations (``ResCapsSegment``).
    """
    bsz, i_dim, c = x.shape
    if len(ws) != 2 * len(blocks):
        raise ValueError(f"res_caps_segment: {len(blocks)} blocks need "
                         f"{2 * len(blocks)} half-weights, got {len(ws)}")
    resolved = []
    for n, (i1, sf, sg) in enumerate(blocks):
        i2 = i_dim - i1
        if not 1 <= i1 < i_dim:
            raise ValueError(f"res_caps_segment: block {n} split i1={i1} "
                             f"outside [1, {i_dim - 1}]")
        wf, wg = ws[2 * n], ws[2 * n + 1]
        if tuple(wf.shape) != (i2, i1 * c, c) or \
                tuple(wg.shape) != (i1, i2 * c, c):
            raise ValueError(
                f"res_caps_segment: block {n} weight shapes "
                f"{tuple(wf.shape)}/{tuple(wg.shape)} do not match the "
                f"i1={i1} coupling of [{bsz}, {i_dim}, {c}]")
        resolved.append((i1, _seg_statics(sf, i2, i1 * c),
                         _seg_statics(sg, i1, i2 * c)))
    return ResCapsSegment.apply(x, tuple(resolved), *ws)
