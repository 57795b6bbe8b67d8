"""Plain PyTorch oracles for the capsule kernels of this package: the
counterparts of ``repro/kernels/ref.py``'s capsule entries.  Each is the
ground truth the kernels and their schedule-following twins are held
against."""

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
