"""Mamba2 (SSD, state-space duality) block: the counterpart of
``repro/models/mamba.py`` -- the chunked matrix form for training and
prefill, the O(1)-state recurrent form for decode.

Decode cache per layer (always fp32, as the reference's stack makes it):
``{"conv": [B, d_conv - 1, CH], "ssd": [B, H, P, N]}``, written in place
by ``mamba_forward``.

Op for op the reference's, with its dtypes: ``dt`` through softplus in
fp32, the decode state in fp32, the causal conv in the activation type
whatever the cache's.  The reference computes the block in jnp with no
Pallas kernel, so the port computes it in plain PyTorch on both backends
(no TPU kernel exists for a port kernel to replace); only its RMSNorm
(``mamba_norm``) runs on K16 under ``backend="kernels"``.  The
reference's ``jax.lax.scan`` over the chunks is a Python loop.

One designed deviation: ``ssd_chunked`` builds the intra-chunk decay as
``exp(diff.masked_fill(~mask, -inf))`` where the reference has
``where(mask, exp(diff), 0)``.  The forward is the same bits (both are
0 above the diagonal and the same ``exp`` on and below it), and so are
the gradients wherever the reference's are finite; but above the
diagonal ``diff`` is positive, and over a long chunk of strong decay
(``|A dt|`` averaging above ~0.7 a step over 128 steps) the reference's
``exp`` overflows to inf and its backward gives ``0 * inf = NaN`` in
``a`` (hence ``dt_proj``, ``dt_bias`` and ``a_log``).  The port's stays
finite.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import init_linear, rmsnorm
from repro_torch.parallel import compat
from repro_torch.parallel.sharding import P, to_placements


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    conv_ch = di + 2 * s.n_groups * s.d_state
    return s, di, nh, conv_ch


def init_mamba_params(generator: torch.Generator, cfg: ModelConfig,
                      dtype: torch.dtype, device: torch.device,
                      lead: tuple[int, ...] = ()) -> dict:
    """The reference's leaves and init laws (``lead`` stacks a pattern
    slot's repeats): the projections, the depthwise conv, ``a_log =
    log(1..H)``, ``ssm_d = 1`` and ``dt_bias``, the inverse softplus of a
    ``dt`` log-uniform in ``[dt_min, dt_max]``."""
    s, di, nh, conv_ch = _dims(cfg)
    d = cfg.d_model

    def lin(d_in, d_out):
        return init_linear(generator, d_in, d_out, dtype, device, lead)

    u = torch.rand(lead + (nh,), generator=generator, dtype=torch.float32,
                   device=device)
    lo, hi = math.log(s.dt_min), math.log(s.dt_max)
    dt = torch.exp(u * (hi - lo) + lo)
    a_log = torch.log(torch.arange(1, nh + 1, dtype=torch.float32,
                                   device=device))
    return {
        "z_proj": lin(d, di),
        "x_proj": lin(d, di),
        "b_proj": lin(d, s.n_groups * s.d_state),
        "c_proj": lin(d, s.n_groups * s.d_state),
        "dt_proj": lin(d, nh),
        "conv_w": torch.randn(lead + (conv_ch, s.d_conv),
                              generator=generator, dtype=dtype,
                              device=device).mul_(0.1),
        "conv_b": torch.zeros(lead + (conv_ch,), dtype=dtype, device=device),
        "a_log": a_log.expand(lead + (nh,)).to(dtype).clone(),
        "ssm_d": torch.ones(lead + (nh,), dtype=dtype, device=device),
        "dt_bias": (dt + torch.log(-torch.expm1(-dt))).to(dtype),
        "mamba_norm": torch.zeros(lead + (di,), dtype=dtype, device=device),
    }


def init_mamba_block(generator: torch.Generator, cfg: ModelConfig,
                     dtype: torch.dtype, device: torch.device,
                     lead: tuple[int, ...] = ()) -> dict:
    """``init_mamba_params`` and the output projection [d_inner, d]."""
    _, di, _, _ = _dims(cfg)
    p = init_mamba_params(generator, cfg, dtype, device, lead)
    p["out_proj"] = init_linear(generator, di, cfg.d_model, dtype, device,
                                lead)
    return p


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device: torch.device, lead: tuple[int, ...] = ()
                     ) -> dict:
    s, _, nh, conv_ch = _dims(cfg)
    return {
        "conv": torch.zeros(lead + (batch, s.d_conv - 1, conv_ch),
                            dtype=dtype, device=device),
        "ssd": torch.zeros(lead + (batch, nh, s.head_dim, s.d_state),
                           dtype=dtype, device=device),
    }


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: torch.Tensor | None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d.  xbc: [B, T, CH], w: [CH, K].

    Returns (silu(out + b) [B, T, CH], new_tail [B, K-1, CH]); computed in
    xbc's type whatever the tail's."""
    k = w.shape[1]
    if tail is None:
        tail = torch.zeros((xbc.shape[0], k - 1, xbc.shape[2]),
                           dtype=xbc.dtype, device=xbc.device)
    full = torch.cat([tail.to(xbc.dtype), xbc], dim=1)
    t = xbc.shape[1]
    out = sum(full[:, i:i + t, :] * w[None, None, :, k - 1 - i]
              for i in range(k))
    new_tail = full[:, -(k - 1):, :] if k > 1 else tail
    return F.silu(out + b), new_tail


def chunk_length(t: int, chunk: int) -> int:
    """The reference's chunk: ``min(chunk, t)``, halved until it divides
    ``t`` (a prime ``t`` runs chunks of 1)."""
    cl = min(chunk, t)
    while t % cl:
        cl //= 2
    return cl


def ssd_chunked(x: torch.Tensor, a: torch.Tensor, bmat: torch.Tensor,
                cmat: torch.Tensor, chunk: int,
                h0: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """SSD scan in chunked matrix form.

    x: [B, T, H, P] (dt folded in), a: [B, T, H] (the log-decay ``A dt``,
    negative), bmat / cmat: [B, T, H, N] (group-expanded).  Returns
    (y [B, T, H, P], the final state [B, H, P, N]), in x's type."""
    b, t, h, p = x.shape
    n = bmat.shape[-1]
    cl = chunk_length(t, chunk)
    nc = t // cl
    xr = x.reshape(b, nc, cl, h, p)
    br = bmat.reshape(b, nc, cl, h, n)
    cr = cmat.reshape(b, nc, cl, h, n)
    ar = a.reshape(b, nc, cl, h).permute(0, 3, 1, 2)      # [B, H, C, L]
    cs = torch.cumsum(ar, dim=-1)

    # Intra-chunk (quadratic).  The masked exp: the module docstring's
    # deviation, 0 above the diagonal with a finite gradient.
    diff = cs[..., :, None] - cs[..., None, :]            # [B,H,C,L,L]
    mask = torch.tril(torch.ones((cl, cl), dtype=torch.bool,
                                 device=x.device))
    lmat = torch.exp(diff.masked_fill(~mask, float("-inf"))).to(x.dtype)
    scores = torch.einsum("bclhn,bcshn->bhcls", cr, br) * lmat
    y_diag = torch.einsum("bhcls,bcshp->bclhp", scores, xr)

    # Per-chunk boundary states.
    decay_states = torch.exp(cs[..., -1:] - cs).to(x.dtype)   # [B,H,C,L]
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", br, decay_states, xr)
    chunk_decay = torch.exp(cs[..., -1]).to(x.dtype)          # [B,H,C]
    decay_out = torch.exp(cs).to(x.dtype)                     # [B,H,C,L]

    carry = (torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
             if h0 is None else h0.to(x.dtype))
    y_off = []
    for c in range(nc):
        y_off.append(torch.einsum("blhn,bhpn->blhp", cr[:, c], carry)
                     * decay_out[:, :, c].transpose(1, 2)[..., None])
        carry = chunk_decay[:, :, c, None, None] * carry + states[:, c]
    y = y_diag + torch.stack(y_off, dim=1)
    return y.reshape(b, t, h, p), carry


def _local_ssd(shd, scan, x, a, bmat, cmat, h0):
    """``scan`` (``ssd_chunked`` or ``ssd_recurrent_step``) of a sharded
    forward on each rank's shard: the scan is independent over the batch
    rows and the heads, so each rank scans its rows (over ``data``) and
    its heads (over ``model``, when it divides ``nh``; otherwise every
    head) on local tensors, from its shard of ``h0`` (None: zeros); the
    results are the DTensors of those shards.  On DTensors the scans'
    einsums flatten the batch with the sharded heads, which torch 2.11's
    DTensor refuses."""
    dp, tp = shd.rules.dp, shd.rules.tp
    heads = tp if x.shape[2] % shd.tp_size() == 0 else None
    rows = dp if x.shape[0] % shd.axis_size(dp) == 0 else None
    xl, bl, cl = (shd.constrain(v, P(rows, None, heads, None)).to_local()
                  for v in (x, bmat, cmat))
    al = shd.constrain(a, P(rows, None, heads)).to_local()
    hl = (None if h0 is None else
          shd.constrain(h0, P(rows, heads, None, None)).to_local())
    y, h = scan(xl, al, bl, cl, hl)
    return (compat.DTensor.from_local(
                y, shd.mesh, to_placements(P(rows, None, heads, None),
                                           shd.mesh), run_check=False),
            compat.DTensor.from_local(
                h, shd.mesh, to_placements(P(rows, heads, None, None),
                                           shd.mesh), run_check=False))


def ssd_recurrent_step(x, a, bmat, cmat, h
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """One decode step.  x: [B, 1, H, P], a: [B, 1, H], b/c: [B, 1, H, N],
    h: [B, H, P, N].  The state is updated in fp32 (it integrates over the
    whole sequence); the output is cast back to x's type."""
    decay = torch.exp(a[:, 0].float())                    # [B, H]
    upd = torch.einsum("bhp,bhn->bhpn", x[:, 0].float(), bmat[:, 0].float())
    h_new = decay[..., None, None] * h.float() + upd
    y = torch.einsum("bhpn,bhn->bhp", h_new, cmat[:, 0].float())
    return y[:, None].to(x.dtype), h_new


def mamba_forward(params: dict, x: torch.Tensor, *, cfg: ModelConfig,
                  cache: dict | None, backend: str = "torch", shd=None
                  ) -> tuple[torch.Tensor, dict | None]:
    """x [B, T, D] -> (out [B, T, D], the cache written in place or None).
    A cache is read as the sequence's state so far (the conv's tail and
    the SSD state); a one-token call with a cache takes the recurrent
    step, any other the chunked form."""
    s, di, nh, _ = _dims(cfg)
    b, t, _ = x.shape
    p, g, n = s.head_dim, s.n_groups, s.d_state

    z = x @ params["z_proj"]
    xi = x @ params["x_proj"]
    bm = x @ params["b_proj"]
    cm = x @ params["c_proj"]
    dt = x @ params["dt_proj"]
    if shd is not None:
        z = shd.act(z, "btf")
        xi = shd.act(xi, "btf")

    xbc = torch.cat([xi, bm, cm], dim=-1)                 # [B, T, CH]
    xbc, new_tail = _causal_conv(xbc, params["conv_w"], params["conv_b"],
                                 None if cache is None else cache["conv"])
    xi, bm, cm = torch.split(xbc, [di, g * n, g * n], dim=-1)

    dt = F.softplus(dt.float() + params["dt_bias"].float())    # [B, T, H]
    a = (-torch.exp(params["a_log"].float()))[None, None] * dt

    xh = xi.reshape(b, t, nh, p) * dt[..., None].to(xi.dtype)
    # Each group's B and C repeated over its nh / g heads (jnp.repeat).
    bh = bm.reshape(b, t, g, 1, n).expand(b, t, g, nh // g, n).reshape(
        b, t, nh, n)
    ch = cm.reshape(b, t, g, 1, n).expand(b, t, g, nh // g, n).reshape(
        b, t, nh, n)

    h0 = None if cache is None else cache["ssd"]
    if t == 1 and cache is not None:
        scan = ssd_recurrent_step
    else:
        def scan(x_, a_, b_, c_, h_):
            return ssd_chunked(x_, a_, b_, c_, s.chunk, h_)
    if shd is not None and shd.active:
        y, h_final = _local_ssd(shd, scan, xh, a, bh, ch, h0)
    else:
        y, h_final = scan(xh, a, bh, ch, h0)

    y = y + params["ssm_d"][None, None, :, None] * xi.reshape(b, t, nh, p)
    y = y.reshape(b, t, di)
    y = rmsnorm(y * F.silu(z), params["mamba_norm"], cfg.norm_eps,
                cfg.norm_fp32, backend)
    out = y @ params["out_proj"]
    if cache is not None:
        cache["conv"].copy_(new_tail)
        cache["ssd"].copy_(h_final)
    return out, cache
