"""Mixture-of-Experts layer: the counterpart of ``repro/models/moe.py``.

A top-k router, the Switch load-balancing aux loss, and capacity-bounded
dispatch and combine, grouped per batch row: a row's tokens compete for
``capacity_for(T)`` buffer slots of each expert, in ``(t, k)`` order
(t-major), and a token past its expert's capacity is dropped (its combine
weight is 0).  DeepSeek-style shared experts run as a dense MLP beside the
routed ones.

The reference writes dispatch and combine as one-hot einsums over three
and four operands.  ``torch.einsum`` contracts those left to right, and
the combine's first pair alone would hold ``[B, E, C, D, T, K]``, so the
port contracts in an explicit order: the ``[B, T, E, C]`` dispatch and
combine weights from the one-hots (and the gates) first, then one
batched matmul with the tokens or the experts' outputs.  Each
``(t, e, c)`` holds at most one ``k`` (a token's K experts differ), so the
weights are the reference's values exactly.

Everything stays on the device: no ``.item()``, no host-side
``one_hot`` (one-hots are comparisons against ``torch.arange``), so the
serving engine captures an MoE decode tick into a CUDA graph.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import init_linear


def init_moe_params(generator: torch.Generator, cfg: ModelConfig,
                    dtype: torch.dtype, device: torch.device,
                    lead: tuple[int, ...] = ()) -> dict:
    """The router ``[d, E]``, the experts' ``[E, d, f]`` gate/up and
    ``[E, f, d]`` down projections (``lead`` stacks a pattern slot's
    repeats), and the shared experts' dense projections if any."""
    e = cfg.moe
    d, f = cfg.d_model, e.d_ff_expert
    scale = (2.0 / (d + f)) ** 0.5

    def experts(shape):
        return torch.randn(lead + shape, generator=generator, dtype=dtype,
                           device=device).mul_(scale)

    p = {"router": init_linear(generator, d, e.num_experts, dtype, device,
                               lead),
         "experts_gate": experts((e.num_experts, d, f)),
         "experts_up": experts((e.num_experts, d, f)),
         "experts_down": experts((e.num_experts, f, d))}
    if e.num_shared_experts:
        fs = f * e.num_shared_experts
        p["shared_gate_proj"] = init_linear(generator, d, fs, dtype, device,
                                            lead)
        p["shared_up_proj"] = init_linear(generator, d, fs, dtype, device,
                                          lead)
        p["shared_down_proj"] = init_linear(generator, fs, d, dtype, device,
                                            lead)
    return p


def capacity_for(tokens: int, cfg_moe) -> int:
    """Buffer slots an expert holds for one batch row of ``tokens``: the
    reference's, rounded up to a multiple of 8 (it decides which tokens
    drop, so the rounding is kept)."""
    cap = math.ceil(tokens * cfg_moe.top_k / cfg_moe.num_experts
                    * cfg_moe.capacity_factor)
    return max(8, -(-cap // 8) * 8)


def moe_forward(params: dict, x: torch.Tensor, *, cfg: ModelConfig,
                shd=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: [B, T, D] -> (out [B, T, D], the aux loss, an fp32 scalar).
    ``shd`` (a ``parallel.sharding.ShardingCtx``) places the router
    probabilities and the grouped dispatch buffers at the reference's
    sites."""
    e = cfg.moe
    b, t, d = x.shape
    n, k = e.num_experts, e.top_k

    logits = (x @ params["router"]).float()                  # [B, T, E]
    probs = torch.softmax(logits, dim=-1)
    if shd is not None:
        probs = shd.act(probs, "bte")
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)       # [B, T, K]
    gate_vals = gate_vals / torch.sum(gate_vals, -1, keepdim=True)

    # Load-balancing auxiliary loss (Switch-style), over all tokens.
    experts = torch.arange(n, device=x.device)
    me = torch.mean(probs, dim=(0, 1))                       # [E]
    ce = torch.mean((gate_idx[..., 0, None] == experts).float(), dim=(0, 1))
    aux = n * torch.sum(me * ce) * e.aux_loss_weight

    cap = capacity_for(t, e)                                 # per row
    onehot = (gate_idx[..., None] == experts).to(torch.int32)  # [B,T,K,E]
    # Buffer position of each (t, k) inside its expert, per row, t-major.
    flat = onehot.reshape(b, t * k, n)
    pos_all = (torch.cumsum(flat, dim=1) * flat - 1).reshape(b, t, k, n)
    pos_sel = torch.gather(pos_all, -1, gate_idx[..., None])[..., 0]
    within = (pos_sel >= 0) & (pos_sel < cap)                # [B, T, K]
    sel = (onehot * within[..., None]).to(x.dtype)           # [B, T, K, E]
    slots = torch.arange(cap, device=x.device)
    pos_oh = ((pos_sel.clamp(0, cap - 1)[..., None] == slots)
              & within[..., None]).to(x.dtype)               # [B, T, K, C]

    # Dispatch: the [B, T, E, C] one-hot, then [B, E*C, T] @ [B, T, D].
    dispatch = torch.einsum("btke,btkc->btec", sel, pos_oh)
    expert_in = torch.bmm(dispatch.reshape(b, t, n * cap).transpose(1, 2),
                          x).reshape(b, n, cap, d)           # [B, E, C, D]
    if shd is not None:
        expert_in = shd.act(expert_in, "becd")
    g = torch.einsum("becd,edf->becf", expert_in, params["experts_gate"])
    u = torch.einsum("becd,edf->becf", expert_in, params["experts_up"])
    h = F.silu(g) * u
    expert_out = torch.einsum("becf,efd->becd", h, params["experts_down"])
    if shd is not None:
        expert_out = shd.act(expert_out, "becd")
    # Combine: the gates onto the one-hot, then [B, T, E*C] @ [B, E*C, D].
    combine = torch.einsum("btke,btkc->btec", sel * gate_vals.to(x.dtype)[
        ..., None], pos_oh)
    out = torch.bmm(combine.reshape(b, t, n * cap),
                    expert_out.reshape(b, n * cap, d))

    if e.num_shared_experts:
        sg = F.silu(x @ params["shared_gate_proj"])
        su = x @ params["shared_up_proj"]
        out = out + (sg * su) @ params["shared_down_proj"]
    return out, aux
