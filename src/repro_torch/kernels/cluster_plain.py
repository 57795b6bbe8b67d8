"""The cluster routing schedule's passes in plain PyTorch.

``csrc/routing_cluster.cuh`` routes each sample over a thread-block
cluster: each rank owns a block of the sample's capsule rows and sums its
share of s over them (one block when its votes are resident, ``block_i``
rows at a time when they are streamed), and the ranks' partials are added
in rank order.  ``replay`` is that schedule over any votes source, so the
twins of K3/K4, K13, K5 and K8/K9 (``votes_routing``, ``primary_routing``:
votes from W and u) and of K14b (``routing``: votes read from u_hat) share
one definition of the order of every sum.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref


def cluster_spans(i_dim: int, cluster: int) -> list[tuple[int, int]]:
    """The rows ``[lo, hi)`` each CTA of a ``cluster``-CTA routing cluster
    owns: blocks of ``ceil(I / cluster)``, the last ragged (or empty)."""
    rows = -(-i_dim // cluster)
    return [(min(i_dim, r * rows), min(i_dim, (r + 1) * rows))
            for r in range(cluster)]


def rank_blocks(i_dim: int, block_i: int, cluster: int,
                resident: bool) -> list[list[slice]]:
    """The row blocks each CTA sums its share of s over, rank by rank:
    each cluster CTA's rows (``cluster_spans``) in ``block_i`` blocks, one
    block when its votes are resident."""
    ranks = []
    for lo, hi in cluster_spans(i_dim, cluster):
        step = max(hi - lo, 1) if resident else block_i
        ranks.append([slice(i, min(hi, i + step)) for i in range(lo, hi,
                                                                 step)])
    return ranks


def replay(uh_of, ranks, b: torch.Tensor, v_shape, *, iters: int,
           two_pass: bool):
    """The forward's ``iters + 1`` passes over the logits ``b`` (updated
    in place; with ``two_pass``, the oracle K13's schedule, a b-pass
    before each s-pass after the first), the votes of a block of rows from
    ``uh_of(rows)`` ([B, rows, J, D]): each rank sums its blocks' share of
    s, and the ranks' partials are added in rank order.  A row's update
    reads only its votes and v_{t-1}, so both schedules give the same
    logits and sums, bit for bit.  Returns ``(b_prev, s_prev, s)``: the
    logits before pass T's update, s_{T-1} and s_T."""
    blocks = [rows for rk in ranks for rows in rk]
    b_prev = s_prev = v = None
    for t in range(iters + 1):
        if t == iters:
            b_prev = b.clone()
        if two_pass and t > 0:                  # K13's separate b-pass
            for rows in blocks:
                b[:, rows] += torch.einsum("bijd,bjd->bij", uh_of(rows), v)
        s = b.new_zeros(v_shape)
        for rk in ranks:
            part = b.new_zeros(v_shape)
            for rows in rk:
                uh4 = uh_of(rows)
                if t > 0 and not two_pass:
                    b[:, rows] += torch.einsum("bijd,bjd->bij", uh4, v)
                c = torch.softmax(b[:, rows], dim=2)
                part = part + torch.einsum("bij,bijd->bjd", c, uh4)
            s = s + part
        if t == iters - 1:
            s_prev = s
        v = ref.squash(s)
    return b_prev, s_prev, s
