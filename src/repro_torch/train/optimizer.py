"""AdamW with a warmup + cosine schedule and global-norm clipping: the
counterpart of ``repro/train/optimizer.py``.

Plain functions over trees of tensors (nested dicts and lists: the
LM's ``blocks["s{i}"]`` stacked leaves and ``prefix`` / ``suffix``
lists, CapsuleNet's flat dict; ``repro_torch.tree``), not a
``torch.optim`` class: the clipping (one global norm over every
gradient, summed in the reference's leaf order) and the schedule must be
the reference's.  ``adamw_update`` updates the parameters and the m / v
moments IN PLACE under ``torch.no_grad()`` (the reference returns new
trees), and returns the same trees.  All arithmetic is float32, as the
reference's; a parameter keeps its own type.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch import tree


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0


def _f32(x, like: torch.Tensor | None = None) -> torch.Tensor:
    dev = like.device if like is not None else None
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def lr_at(step, cfg: OptConfig) -> torch.Tensor:
    """Learning rate at ``step`` (an int or a 0-d tensor): linear warmup
    to ``peak_lr``, then cosine decay to ``min_lr_ratio * peak_lr`` at
    ``decay_steps``."""
    step = _f32(step)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init_opt_state(params: Any) -> dict:
    """``{"m": zeros, "v": zeros, "step": int32 0}``, m and v float32
    trees of the params' structure: the reference's layout (so
    checkpoints of the two agree key for key)."""
    dev = tree.leaves(params)[0].device

    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)

    return {"m": tree.tree_map(zeros, params),
            "v": tree.tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(grads: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tree.leaves(grads)))


def adamw_update(params: Any, grads: Any, state: dict,
                 cfg: OptConfig) -> tuple[Any, dict, dict]:
    """One AdamW step with the gradients clipped to ``clip_norm`` by
    their global norm.  ``grads`` is a tree of the params' structure, or
    their leaves in ``tree.leaves`` order.  Updates ``params`` and
    ``state`` in place and returns ``(params, state, {"grad_norm",
    "lr"})``."""
    with torch.no_grad():
        step = state["step"] + 1
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
        lr = lr_at(step, cfg).to(gnorm.device)
        stepf = step.float()
        b1c = 1 - _f32(cfg.b1, gnorm) ** stepf
        b2c = 1 - _f32(cfg.b2, gnorm) ** stepf
        for p, g, m, v in zip(*map(tree.leaves, (params, grads, state["m"],
                                                 state["v"])), strict=True):
            # The reference's arithmetic, op for op (each op rounds once),
            # with the temporaries reused in place: at full width a leaf
            # is gigabytes.
            g = g.float() * scale                   # a new tensor
            m.mul_(cfg.b1).add_(g.mul((1 - cfg.b1)))
            v.mul_(cfg.b2).add_(g.square_().mul_(1 - cfg.b2))
            del g
            u = m / b1c
            u.div_(torch.div(v, b2c).sqrt_().add_(cfg.eps))
            u.add_(p.float().mul(cfg.weight_decay))
            if p.dtype == torch.float32:
                p.sub_(u.mul_(lr))
            else:
                p.copy_(p.float() - u.mul_(lr))
        state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
