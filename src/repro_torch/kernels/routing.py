"""Split-path routing (K14b) over a materialized u_hat.

The counterpart of ``repro/kernels/routing.py`` (``_routing_kernel``):
u_hat [B, I, J*D] -> v [B, J*D], every routing iteration in one kernel,
inference only (no stop-gradient).  ``routing`` runs ``routing_plain`` for
CPU tensors and the CUDA kernel (``csrc/routing.cu``, each sample on a
thread-block cluster of ``cluster`` CTAs) for CUDA tensors.  The twin
follows the kernel's schedule (``cluster_plain.replay``): ``iters + 1``
passes, pass ``t`` folding the logits update of iteration ``t`` into the
accumulation of ``s_t``, each rank summing s over its own rows (all at
once when its rows of u_hat are ``resident`` on chip, ``block_i`` at a
time when ``streamed``) and the ranks' partials added in rank order --
the fused s+b schedule of ``votes_routing``, with the votes read instead
of recomputed.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.execplan import (CLUSTER_SIZES, plan_routing_split,
                                       routing_split_cluster_smem)
from repro_torch.core.planner import SMEM_BYTES
from repro_torch.kernels import ref
from repro_torch.kernels.build import (Kernel, cluster_query, on_cpu, ptr,
                                       stream_of)
from repro_torch.kernels.cluster_plain import rank_blocks, replay

_P, _I = ctypes.c_void_p, ctypes.c_int
ROUTING_CLUSTER = Kernel("routing", "routing_cluster_f32",
                         [_P, _P] + [_I] * 9 + [_P])
PLACEMENTS = ("resident", "streamed")


def routing_plain(u_hat: torch.Tensor, *, iters: int, num_classes: int,
                  block_i: int, mode: str = "streamed",
                  cluster: int = 1) -> torch.Tensor:
    """The kernel's schedule in plain PyTorch: u_hat [B, I, J*D] ->
    v [B, J*D] on a ``cluster``-CTA cluster (1: one CTA's order, the
    ``block_i`` blocks summed in turn)."""
    bsz, i_dim, jd = u_hat.shape
    j, d = num_classes, jd // num_classes
    uh4 = u_hat.reshape(bsz, i_dim, j, d)
    b = u_hat.new_zeros((bsz, i_dim, j))
    _, _, s = replay(lambda rows: uh4[:, rows],
                     rank_blocks(i_dim, block_i, cluster, mode == "resident"),
                     b, (bsz, j, d), iters=iters, two_pass=False)
    return ref.squash(s).reshape(bsz, jd)


def planned_cluster(i_dim: int, num_classes: int, jd: int, iters: int,
                    batch: int, mode: str, block_i: int) -> int:
    """The planner's K14b cluster size at ``batch`` for this placement and
    i-tile."""
    try:
        sched = plan_routing_split(i_dim, num_classes, jd, iters=iters,
                                   batch=batch, votes=mode, block_i=block_i)
    except ValueError as err:
        raise ValueError(f"routing: no cluster of {CLUSTER_SIZES} CTAs "
                         f"holds {mode} rows of {i_dim} capsules -> {jd} "
                         f"at block_i={block_i}") from err
    return sched.cluster.cluster


def routing(u_hat: torch.Tensor, *, iters: int = 3, num_classes: int = 10,
            mode: str = "streamed", block_i: int = 128,
            cluster: int | None = None) -> torch.Tensor:
    """K14b: u_hat [B, I, J*D] -> v [B, J*D] after ``iters`` routing
    iterations, each sample on a cluster of ``cluster`` CTAs (None: the
    planner's size at this batch), each CTA's rows of u_hat copied on chip
    once (``mode="resident"``) or ``block_i`` rows a pass (``streamed``;
    the tile clamped to a CTA's rows).  A refused launch raises, naming
    its grid and shared memory; nothing falls back."""
    if u_hat.dim() != 3:
        raise ValueError(f"routing: u_hat must be [B, I, J*D], got "
                         f"{tuple(u_hat.shape)}")
    bsz, i_dim, jd = u_hat.shape
    if num_classes < 1 or jd % num_classes:
        raise ValueError(f"votes dim {jd} not divisible by classes "
                         f"{num_classes}")
    if iters < 0:
        raise ValueError(f"routing needs iters >= 0, got {iters}")
    if mode not in PLACEMENTS:
        raise ValueError(f"routing: u_hat rows {mode!r}; choose from "
                         f"{PLACEMENTS}")
    block_i = max(1, min(block_i, i_dim))
    if cluster is None:
        cluster = planned_cluster(i_dim, num_classes, jd, iters,
                                  max(bsz, 1), mode, block_i)
    elif cluster not in CLUSTER_SIZES:
        raise ValueError(f"routing: a cluster of {cluster} CTAs; clusters "
                         f"are {CLUSTER_SIZES} CTAs")
    if on_cpu("routing", u_hat):
        return routing_plain(u_hat, iters=iters, num_classes=num_classes,
                             block_i=block_i, mode=mode, cluster=cluster)
    j = num_classes
    smem = routing_split_cluster_smem(mode, i_dim, block_i, j, jd, cluster)
    if smem > SMEM_BYTES:
        raise ValueError(f"routing: {mode} rows (block_i={block_i}) on "
                         f"{cluster}-CTA clusters need {smem} B of shared "
                         f"memory per CTA, over {SMEM_BYTES} B")
    out = torch.empty((bsz, jd), dtype=u_hat.dtype, device=u_hat.device)
    if bsz:
        try:
            ROUTING_CLUSTER(ptr(u_hat), ptr(out), bsz, i_dim, j, jd // j,
                            iters, int(mode == "resident"), block_i, cluster,
                            smem, stream_of(u_hat))
        except RuntimeError as err:
            raise RuntimeError(
                f"routing: the launch of {bsz} clusters of {cluster} CTAs "
                f"({smem} B of shared memory each) was refused: "
                f"{err}") from err
    return out


def cluster_occupancy(i_dim: int, num_classes: int, out_dim: int, *,
                      mode: str, block_i: int,
                      cluster: int) -> dict[str, int]:
    """On the card: how many K14b clusters of this schedule run at once,
    and the kernel's attributes (``build.cluster_query``)."""
    return cluster_query("routing", "routing_cluster_occupancy", i_dim,
                         num_classes, out_dim, cluster,
                         int(mode == "resident"), block_i)
