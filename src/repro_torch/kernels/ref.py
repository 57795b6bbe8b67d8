"""Plain PyTorch oracles for the kernels of this package: the
counterparts of ``repro/kernels/ref.py``.  Each is the ground truth the
kernels and their schedule-following twins are held against."""

from __future__ import annotations

import torch


def squash(s: torch.Tensor, dim: int = -1, eps: float = 1e-7) -> torch.Tensor:
    sq = torch.sum(s * s, dim=dim, keepdim=True)
    return (sq / (1.0 + sq)) * s * torch.rsqrt(sq + eps)


def caps_votes(u: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """u: [B, I, C], w: [I, JD, C] -> votes [B, I, JD] (JD = classes*dim)."""
    return torch.einsum("bic,inc->bin", u, w)


def routing(u_hat: torch.Tensor, iters: int) -> torch.Tensor:
    """u_hat: [B, I, J, D] -> v: [B, J, D] (inference-mode dynamic routing)."""
    b = torch.zeros(u_hat.shape[:3], dtype=u_hat.dtype, device=u_hat.device)
    for _ in range(iters):
        c = torch.softmax(b, dim=2)
        v = squash(torch.einsum("bij,bijd->bjd", c, u_hat))
        b = b + torch.einsum("bijd,bjd->bij", u_hat, v)
    c = torch.softmax(b, dim=2)
    return squash(torch.einsum("bij,bijd->bjd", c, u_hat))


def squash_vjp(s: torch.Tensor, g: torch.Tensor,
               eps: float = 1e-7) -> torch.Tensor:
    """VJP of ``squash`` over the last axis at pre-activation ``s``.

    With ``v = f(q) s``, ``q = ||s||^2``, ``f = q / (1 + q) / sqrt(q + eps)``:
    ``ds = f g + 2 f'(q) <g, s> s``, where
    ``f'(q) = r / (1 + q)^2 - a r^3 / 2``, ``a = q / (1 + q)``,
    ``r = (q + eps)^-1/2``.  The CUDA backward kernels evaluate the same
    formula (``routing_bwd.cuh``)."""
    q = torch.sum(s * s, dim=-1, keepdim=True)
    a = q / (1.0 + q)
    r = torch.rsqrt(q + eps)
    fq = a * r
    dfq = r / torch.square(1.0 + q) - 0.5 * a * r * r * r
    gs = torch.sum(g * s, dim=-1, keepdim=True)
    return fq * g + 2.0 * dfq * gs * s


def softmax_vjp(c: torch.Tensor, dc: torch.Tensor,
                dim: int = -1) -> torch.Tensor:
    """VJP of a softmax over ``dim`` given its OUTPUT ``c``."""
    return c * (dc - torch.sum(c * dc, dim=dim, keepdim=True))


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * (1.0 + weight.float())
            ).to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              softcap: float | None = None,
              scale: float | None = None) -> torch.Tensor:
    """q: [B, H, Tq, D], k/v: [B, H, Tk, D] -> [B, H, Tq, D] (fp32 softmax).

    ``window`` is a sliding-window radius: query t attends to keys in
    (t - window, t] (causal) -- Gemma-style local attention.  Query rows
    align with the keys' end (``q_offset = Tk - Tq``, decode-friendly).
    """
    d = q.shape[-1]
    scale = (d ** -0.5) if scale is None else scale
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    tq, tk = q.shape[2], k.shape[2]
    qi = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
    ki = torch.arange(tk, device=q.device)[None, :]
    mask = torch.ones((tq, tk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= ki <= qi
    if window is not None:
        mask &= ki > qi - window
    logits = torch.where(mask, logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v)
