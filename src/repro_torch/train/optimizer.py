"""AdamW with a warmup + cosine schedule and global-norm clipping: the
counterpart of ``repro/train/optimizer.py``.

Plain functions over dicts of tensors, not a ``torch.optim`` class: the
clipping (one global norm over every gradient) and the schedule must be
the reference's.  ``adamw_update`` updates the parameters and the m / v
moments IN PLACE under ``torch.no_grad()`` (the reference returns new
trees), and returns the same dicts.  All arithmetic is float32, as the
reference's.
"""

from __future__ import annotations

import dataclasses
import math

import torch


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


def init_opt_state(params: dict[str, torch.Tensor]) -> dict:
    """``{"m": zeros, "v": zeros, "step": int32 0}``, the reference's
    layout (so checkpoints of the two agree key for key)."""
    dev = next(iter(params.values())).device
    return {"m": {k: torch.zeros_like(p, dtype=torch.float32)
                  for k, p in params.items()},
            "v": {k: torch.zeros_like(p, dtype=torch.float32)
                  for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tensors: dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors.values()))


def adamw_update(params: dict[str, torch.Tensor],
                 grads: dict[str, torch.Tensor], state: dict,
                 cfg: OptConfig) -> tuple[dict, dict, dict]:
    """One AdamW step with the gradients clipped to ``clip_norm`` by
    their global norm.  Updates ``params`` and ``state`` in place and
    returns ``(params, state, {"grad_norm", "lr"})``."""
    with torch.no_grad():
        step = state["step"] + 1
        gnorm = global_norm(grads)
        scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
        lr = lr_at(step, cfg).to(gnorm.device)
        stepf = step.float()
        b1c = 1 - _f32(cfg.b1, gnorm) ** stepf
        b2c = 1 - _f32(cfg.b2, gnorm) ** stepf
        for k, p in params.items():
            g = grads[k].float() * scale
            m, v = state["m"][k], state["v"][k]
            m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
            v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
            u = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
            u = u + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * u)
        state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
