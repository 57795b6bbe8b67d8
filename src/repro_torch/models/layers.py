"""Shared layers of the LM family: the counterpart of
``repro/models/layers.py`` (RMSNorm, RoPE, gated MLP, embeddings, LM head).

``rmsnorm`` has the port's backend switch: ``"kernels"`` runs K16
(``ops.rmsnorm``) for the reference's fp32 form, ``"torch"`` the plain
form.  The reference's low-precision form (``fp32=False``, no Pallas
kernel) is ``RMSNormLowp`` on both backends: an autograd Function with
the reference's hand-written backward (``_rmsnorm_lowp``'s custom
VJP).  ``rs_proj`` / ``ag_seq`` are the reference's Megatron-SP
collectives (``cfg.manual_tp``): an explicit reduce-scatter of the
row-parallel projection over the sequence dim, and the all-gather of the
sequence-sharded residual, on the ``model`` axis's process group.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.parallel import compat
from repro_torch.parallel.sharding import P, to_placements

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
              down_w: torch.Tensor, act: str = "silu", shd=None,
              manual_tp: bool = False) -> torch.Tensor:
    """SwiGLU (``act="silu"``) or GeGLU (``"gelu"``, the tanh form of the
    reference's ``gelu(approximate=True)``).  ``shd`` places the hidden
    over ``model``; ``manual_tp`` projects it down through ``rs_proj``."""
    g = x @ gate_w
    u = x @ up_w
    if act == "gelu":
        h = F.gelu(g, approximate="tanh") * u
    else:
        h = F.silu(g) * u
    if shd is not None:
        h = shd.act(h, "btf")
    if manual_tp:
        return rs_proj(h, down_w, shd)
    return h @ down_w


# ---------------------------------------------------------------------------
# Manual Megatron-SP collectives: the SP <-> TP transitions as explicit
# collectives on the model axis's group, on the local shards of DTensors.
# ---------------------------------------------------------------------------

def _dim_first(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x.movedim(dim, 0).contiguous()


class _ReduceScatterSeq(torch.autograd.Function):
    """Sum the ranks' partial products and keep this rank's chunk of
    ``dim``; the backward all-gathers the chunk's gradient."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n = dist.get_world_size(group)
        xt = _dim_first(x, dim)
        out = xt.new_empty((xt.shape[0] // n,) + xt.shape[1:])
        compat.reduce_scatter_single(out, xt, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        gt = _dim_first(g, ctx.dim)
        out = gt.new_empty((gt.shape[0] * n,) + gt.shape[1:])
        compat.all_gather_single(out, gt, group=ctx.group)
        return out.movedim(0, ctx.dim), None, None


class _AllGatherSeq(torch.autograd.Function):
    """Gather every rank's chunk of ``dim``.  Its output is wrapped as a
    DTensor replicated over the group, and DTensor sums the gradient of a
    replicated tensor over the group before it reaches this backward, so
    the backward keeps this rank's chunk of that sum."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        n = dist.get_world_size(group)
        xt = _dim_first(x, dim)
        out = xt.new_empty((xt.shape[0] * n,) + xt.shape[1:])
        compat.all_gather_single(out, xt, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        rank = dist.get_rank(ctx.group)
        return g.chunk(n, dim=ctx.dim)[rank].contiguous(), None, None


def _manual_ok(x: torch.Tensor, shd) -> bool:
    return (shd is not None and shd.active
            and x.shape[1] % shd.tp_size() == 0)


def rs_proj(x: torch.Tensor, w: torch.Tensor, shd) -> torch.Tensor:
    """Row-parallel projection with an explicit reduce-scatter over the
    sequence dim: x [B, T, F] (F model-sharded) @ w [F, D] -> [B, T, D]
    sequence-sharded over the model axis.  The plain product without a
    mesh or when T does not divide by the TP size."""
    if not _manual_ok(x, shd):
        return x @ w
    dp, tp = shd.rules.dp, shd.rules.tp
    xl = shd.constrain(x, P(dp, None, tp)).to_local()
    w_spec = P(tp, None)
    # w's local gradient is this data shard's part of the sum over dp.
    w_grad = [compat.Partial() if p.is_replicate() else p
              for p in to_placements(w_spec, shd.mesh)]
    wl = shd.constrain(w, w_spec).to_local(grad_placements=w_grad)
    y = _ReduceScatterSeq.apply(xl @ wl, 1, shd.tp_group())
    return compat.DTensor.from_local(
        y, shd.mesh, to_placements(P(dp, tp, None), shd.mesh),
        run_check=False)


def ag_seq(x: torch.Tensor, shd) -> torch.Tensor:
    """All-gather the sequence-sharded residual (the SP -> TP transition):
    [B, T, D] sequence-sharded over the model axis -> replicated over it."""
    if not _manual_ok(x, shd):
        return x
    dp, tp = shd.rules.dp, shd.rules.tp
    xl = shd.constrain(x, P(dp, tp, None)).to_local()
    y = _AllGatherSeq.apply(xl, 1, shd.tp_group())
    return compat.DTensor.from_local(
        y, shd.mesh, to_placements(P(dp, None, None), shd.mesh),
        run_check=False)


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor, scale: bool,
                 d_model: int) -> torch.Tensor:
    """Row gather; Gemma's ``x *= sqrt(d_model)`` multiplies in x's type
    (the factor rounded to it first, as ``jnp.asarray(.., x.dtype)``).
    ``F.embedding``, not ``embed[tokens]``: indexing's backward is an
    accumulating ``index_put``, whose DTensor strategy in torch 2.11
    fails on a batch-sharded index (an unnormalised ``Shard(-1)``);
    the embedding's backward has a strategy of its own."""
    x = F.embedding(tokens, embed)
    if compat.is_dtensor(x):
        # A vocab-sharded table gives a masked partial sum (each rank its
        # rows): reduce it here.  Redistributed straight to a batch- and
        # sequence-sharded layout, DTensor applies the whole batch's
        # mask to a batch shard.
        x = x.redistribute(x.device_mesh, [
            compat.Replicate() if p.is_partial() else p
            for p in x.placements])
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
        if compat.is_dtensor(logits):
            # A slice of the (vocab-sharded) last dim is no view of a
            # DTensor: mask the padded columns instead, the same values.
            pad = torch.arange(logits.shape[-1],
                               device=logits.device) >= valid_vocab
            logits = logits.masked_fill(pad, NEG_INF)
        else:
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
