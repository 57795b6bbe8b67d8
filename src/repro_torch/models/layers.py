"""Shared layers of the LM family: the counterpart of
``repro/models/layers.py`` (RMSNorm, RoPE, gated MLP, embeddings, LM head).

``rmsnorm`` has the port's backend switch: ``"kernels"`` runs K16
(``ops.rmsnorm``) for the reference's fp32 form, ``"torch"`` the plain
form.  The reference's low-precision form (``fp32=False``, no Pallas
kernel) is ``RMSNormLowp`` on both backends: an autograd Function with
the reference's hand-written backward (``_rmsnorm_lowp``'s custom
VJP).  The reference's ``rs_proj`` / ``ag_seq`` (Megatron-SP
collectives) wait for ``parallel/`` (ROADMAP queue 1, item 11f).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref

BACKENDS = ("torch", "kernels")
NEG_INF = -1e30


class RMSNormLowp(torch.autograd.Function):
    """RMSNorm with fp32 statistics whose backward keeps every full-size
    tensor in x's type: fp32 appears only in the ``[..., 1]`` reduction
    and in dw (the reference's ``_rmsnorm_lowp`` and its custom VJP)."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
        scale32 = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, weight, scale32)
        return x * scale32.to(x.dtype) * (1.0 + weight.to(x.dtype))

    @staticmethod
    def backward(ctx, dy):
        x, weight, scale32 = ctx.saved_tensors
        scale = scale32.to(x.dtype)
        dxhat = dy * (1.0 + weight.to(x.dtype))             # full-size, x's
        m = torch.mean((dxhat * x).float(), dim=-1, keepdim=True)
        coef = (scale32 ** 3 * m).to(x.dtype)                # [..., 1]
        dx = dxhat * scale - x * coef                        # full-size, x's
        dw = torch.sum((dy * x * scale).float(),
                       dim=tuple(range(dy.dim() - 1)))       # [D] fp32
        return dx, dw.to(weight.dtype), None


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6,
            fp32: bool = True, backend: str = "torch") -> torch.Tensor:
    """RMSNorm with fp32 statistics.  ``fp32=True`` also applies the
    normalisation in fp32 (K16 on ``backend="kernels"``); ``fp32=False``
    applies it in x's type, forward and backward (``RMSNormLowp``)."""
    if fp32:
        if backend == "kernels":
            return ops.rmsnorm(x, weight, eps=eps)
        return ref.rmsnorm(x, weight, eps)
    return RMSNormLowp.apply(x, weight, eps)


def rope_tables(positions: torch.Tensor, theta: float, dim: int,
                dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """cos and sin ``[B, T, 1, dim // 2]`` of the rotary embedding at
    ``positions`` [B, T] (absolute): computed in fp32 and cast to
    ``dtype``, as the reference does.  A forward computes them once for
    all its layers (``attention.AttnInputs``)."""
    half = dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    angles = positions[..., None].float() * freqs            # [B, T, half]
    return (torch.cos(angles)[:, :, None, :].to(dtype),
            torch.sin(angles)[:, :, None, :].to(dtype))


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """Rotate-half rotary embedding of x [B, T, H, D] by ``rope_tables``'
    cos/sin, over x's first ``2 * cos.shape[-1]`` features."""
    half = cos.shape[-1]
    d = 2 * half
    rot, rest = x[..., :d], x[..., d:]
    x1, x2 = rot[..., :half], rot[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([rotated, rest], dim=-1) if rest.numel() else rotated


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0,
         rope_dim: int | None = None) -> torch.Tensor:
    """Rotary embedding, rotate-half layout.  x: [B, T, H, D], positions:
    [B, T] (absolute).  cos/sin are computed in fp32 and cast to x's type
    before the multiply, as the reference does."""
    d = x.shape[-1] if rope_dim is None else rope_dim
    return apply_rope(x, *rope_tables(positions, theta, d, x.dtype))


def gated_mlp(x: torch.Tensor, gate_w: torch.Tensor, up_w: torch.Tensor,
              down_w: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """SwiGLU (``act="silu"``) or GeGLU (``"gelu"``, the tanh form of the
    reference's ``gelu(approximate=True)``)."""
    g = x @ gate_w
    u = x @ up_w
    if act == "gelu":
        h = F.gelu(g, approximate="tanh") * u
    else:
        h = F.silu(g) * u
    return h @ down_w


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor, scale: bool,
                 d_model: int) -> torch.Tensor:
    """Row gather; Gemma's ``x *= sqrt(d_model)`` multiplies in x's type
    (the factor rounded to it first, as ``jnp.asarray(.., x.dtype)``)."""
    x = embed[tokens]
    if scale:
        x = x * torch.tensor(d_model ** 0.5, dtype=x.dtype)
    return x


def lm_head(x: torch.Tensor, embed_or_unembed: torch.Tensor, tied: bool,
            softcap: float | None, fp32: bool = True,
            valid_vocab: int | None = None) -> torch.Tensor:
    """Logits over the padded vocab; padded columns are masked to -1e30."""
    w = embed_or_unembed.T if tied else embed_or_unembed
    logits = x @ w.to(x.dtype)
    if fp32:
        logits = logits.float()
    if softcap is not None:
        logits = torch.tanh(logits / softcap) * softcap
    if valid_vocab is not None and valid_vocab < logits.shape[-1]:
        logits[..., valid_vocab:] = NEG_INF
    return logits


def init_linear(generator: torch.Generator, d_in: int, d_out: int,
                dtype: torch.dtype, device: torch.device,
                lead: tuple[int, ...] = ()) -> torch.Tensor:
    """``sqrt(2 / (d_in + d_out)) * N(0, 1)`` of shape ``lead + (d_in,
    d_out)``, drawn on ``device`` (``lead`` stacks the repeats of a
    pattern slot without a second copy)."""
    scale = (2.0 / (d_in + d_out)) ** 0.5
    w = torch.randn(lead + (d_in, d_out), generator=generator, dtype=dtype,
                    device=device)
    return w.mul_(scale)
