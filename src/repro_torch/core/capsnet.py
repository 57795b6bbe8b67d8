"""CapsuleNet (Sabour et al. 2017) in PyTorch: the counterpart of
``repro/core/capsnet.py``.

Conv1 (9x9, 1->256, ReLU) -> PrimaryCaps (9x9 conv, 256 -> 32 capsules x
8D, stride 2) -> ClassCaps (routing-by-agreement to 10 capsules x 16D),
plus the reconstruction decoder and the margin loss.  Layouts are the
reference's, so weights move over with no transposes: images NHWC, conv
weights HWIO, ``cc_w [I, J, D, C]``.

``forward(backend="torch")`` is the plain reference path (the counterpart
of ``backend="jnp"``); ``backend="kernels"`` runs the plan-driven path
through the hand-written CUDA kernels of ``repro_torch.kernels`` (the
counterpart of ``backend="pallas"``).  On CPU tensors every kernel wrapper
runs its plain twin, so the plan-driven path is testable without a card.
Both backends are differentiable: ``total_loss`` trains through the
kernels' ``torch.autograd.Function``s, whose backward runs the backward
kernels (K6-K9; for ResCaps stacks the reversible segment K12) on the
plan's ``-bwd`` schedules.

Under a ``torch.profiler`` session (``repro_torch.obs``) the kernels
forward records one ``plan.<op name>`` span per plan op and both backends
``model.decode``; ``train_step`` records ``train.step`` over
``train.forward``, ``train.backward`` (``loss_and_grads``) and
``train.update``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.device import resolve_device

# Plan-op name of one fused votes+routing layer: the final (classification)
# layer keeps the bare name, intermediate layers of a deep stack get an
# index suffix ("ClassCaps-Routing[0]", ...).
ROUTING_NAME = "ClassCaps-Routing"

BACKENDS = ("torch", "kernels")


@dataclasses.dataclass(frozen=True)
class CapsLayerSpec:
    """One plain routing-capsule layer of a deep stack: votes + routing
    from however many capsules flow in to ``num_caps`` capsules of
    ``caps_dim`` dimensions."""

    num_caps: int
    caps_dim: int
    routing_iters: int = 3


@dataclasses.dataclass(frozen=True)
class ResCapsBlock:
    """One reversible residual capsule block: ``x [B, I, C]`` splits into
    ``x1 [B, I//2, C]`` / ``x2`` and runs the additive coupling
    ``y1 = x1 + F(x2)``, ``y2 = x2 + G(y1)`` of two routing halves."""

    routing_iters: int = 3


@dataclasses.dataclass(frozen=True)
class RoutingLayer:
    """One resolved votes+routing instance of the layer graph (see
    ``CapsNetConfig.routing_stack``).  ``name`` is the plan-op name,
    ``param`` the params key, ``half`` marks residual coupling halves."""

    name: str
    param: str
    in_caps: int
    in_dim: int
    num_caps: int
    caps_dim: int
    iters: int
    block: int | None = None     # caps_layers entry index (residual only)
    half: str | None = None      # "f" | "g" coupling half

    @property
    def jd(self) -> int:
        return self.num_caps * self.caps_dim

    @property
    def residual(self) -> bool:
        return self.half is not None


@dataclasses.dataclass(frozen=True)
class CapsNetConfig:
    image_hw: int = 28
    in_channels: int = 1
    conv1_channels: int = 256
    conv1_kernel: int = 9
    pc_kernel: int = 9
    pc_stride: int = 2
    num_primary_groups: int = 32     # capsule groups (channels / primary_dim)
    primary_dim: int = 8
    num_classes: int = 10
    class_dim: int = 16
    routing_iters: int = 3
    decoder_hidden: tuple[int, int] = (512, 1024)
    use_decoder: bool = True
    # Intermediate routing layers between PrimaryCaps and the final
    # ClassCaps layer (``CapsLayerSpec`` / ``ResCapsBlock`` entries).
    caps_layers: tuple = ()

    @property
    def conv1_out(self) -> int:
        return self.image_hw - self.conv1_kernel + 1

    @property
    def pc_out(self) -> int:
        return (self.conv1_out - self.pc_kernel) // self.pc_stride + 1

    @property
    def num_primary(self) -> int:
        return self.pc_out * self.pc_out * self.num_primary_groups

    @property
    def pc_channels(self) -> int:
        return self.num_primary_groups * self.primary_dim

    def routing_stack(self) -> tuple[RoutingLayer, ...]:
        """Flatten ``caps_layers`` + the final ClassCaps layer into the
        resolved routing-layer chain (see ``RoutingLayer``)."""
        layers: list[RoutingLayer] = []
        i, c = self.num_primary, self.primary_dim
        idx = 0
        for k, entry in enumerate(self.caps_layers):
            if isinstance(entry, ResCapsBlock):
                if i < 2:
                    raise ValueError(
                        f"caps_layers[{k}]: ResCapsBlock needs >= 2 incoming "
                        f"capsules to split the coupling halves, got {i}")
                i1, i2 = i // 2, i - i // 2
                layers.append(RoutingLayer(
                    name=f"{ROUTING_NAME}[{idx}]", param=f"cc{idx}_w",
                    in_caps=i2, in_dim=c, num_caps=i1, caps_dim=c,
                    iters=entry.routing_iters, block=k, half="f"))
                idx += 1
                layers.append(RoutingLayer(
                    name=f"{ROUTING_NAME}[{idx}]", param=f"cc{idx}_w",
                    in_caps=i1, in_dim=c, num_caps=i2, caps_dim=c,
                    iters=entry.routing_iters, block=k, half="g"))
                idx += 1
            elif isinstance(entry, CapsLayerSpec):
                if entry.num_caps < 1 or entry.caps_dim < 1:
                    raise ValueError(
                        f"caps_layers[{k}]: num_caps/caps_dim must be >= 1, "
                        f"got {entry.num_caps}x{entry.caps_dim}")
                layers.append(RoutingLayer(
                    name=f"{ROUTING_NAME}[{idx}]", param=f"cc{idx}_w",
                    in_caps=i, in_dim=c, num_caps=entry.num_caps,
                    caps_dim=entry.caps_dim, iters=entry.routing_iters))
                idx += 1
                i, c = entry.num_caps, entry.caps_dim
            else:
                raise TypeError(
                    f"caps_layers[{k}]: expected CapsLayerSpec or "
                    f"ResCapsBlock, got {type(entry).__name__}")
        layers.append(RoutingLayer(
            name=ROUTING_NAME, param="cc_w", in_caps=i, in_dim=c,
            num_caps=self.num_classes, caps_dim=self.class_dim,
            iters=self.routing_iters))
        return tuple(layers)


Params = dict[str, Any]


def _he_normal(shape: tuple[int, ...], fan_in: int,
               gen: torch.Generator) -> torch.Tensor:
    """``jax.nn.initializers.he_normal``: a normal truncated at two
    standard deviations, rescaled to variance ``2 / fan_in``."""
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    return torch.nn.init.trunc_normal_(torch.empty(shape), std=std,
                                       a=-2 * std, b=2 * std, generator=gen)


def init_params(generator: torch.Generator,
                cfg: CapsNetConfig = CapsNetConfig(), *,
                device: str | torch.device = "cuda") -> Params:
    """Random parameters with the reference's keys, shapes and init laws.

    The values differ from the reference's (another generator); parity
    tests copy the reference's values instead (``repro_torch.convert``).
    """
    dev = resolve_device(device)
    stack = cfg.routing_stack()
    final = stack[-1]
    k1, k2 = cfg.conv1_kernel, cfg.pc_kernel
    params: Params = {
        "conv1_w": _he_normal((k1, k1, cfg.in_channels, cfg.conv1_channels),
                              k1 * k1 * cfg.in_channels, generator),
        "conv1_b": torch.zeros(cfg.conv1_channels),
        "pc_w": _he_normal((k2, k2, cfg.conv1_channels, cfg.pc_channels),
                           k2 * k2 * cfg.conv1_channels, generator),
        "pc_b": torch.zeros(cfg.pc_channels),
    }
    for lay in stack:
        params[lay.param] = 0.1 * torch.randn(
            (lay.in_caps, lay.num_caps, lay.caps_dim, lay.in_dim),
            generator=generator)
    if cfg.use_decoder:
        d_in = cfg.num_classes * cfg.class_dim
        h1, h2 = cfg.decoder_hidden
        d_out = cfg.image_hw * cfg.image_hw * cfg.in_channels
        params["dec_w1"] = _he_normal((d_in, h1), d_in, generator)
        params["dec_b1"] = torch.zeros(h1)
        params["dec_w2"] = _he_normal((h1, h2), h1, generator)
        params["dec_b2"] = torch.zeros(h2)
        params["dec_w3"] = _he_normal((h2, d_out), h2, generator)
        params["dec_b3"] = torch.zeros(d_out)
    return {k: v.to(dev) for k, v in params.items()}


def squash(s: torch.Tensor, dim: int = -1, eps: float = 1e-7) -> torch.Tensor:
    """v = ||s||^2 / (1 + ||s||^2) * s / ||s|| (paper Sec. 2.1)."""
    sq = torch.sum(s * s, dim=dim, keepdim=True)
    return (sq / (1.0 + sq)) * s * torch.rsqrt(sq + eps)


def compute_votes(u: torch.Tensor, cc_w: torch.Tensor) -> torch.Tensor:
    """u_hat[b, i, j, d] = W[i, j, d, c] u[b, i, c]  (the CC-FC operation)."""
    return torch.einsum("bic,ijdc->bijd", u, cc_w)


def routing_by_agreement(u_hat: torch.Tensor, iters: int) -> torch.Tensor:
    """Dynamic routing (paper Fig. 2 feedback loop).  u_hat: [B, I, J, D].

    Keeps the reference's stop-gradient convention: the logits updates
    see a detached ``u_hat`` and only the last iteration's ``s`` (and the
    readout) carry its gradient.
    """
    b = torch.zeros(u_hat.shape[:3], dtype=u_hat.dtype, device=u_hat.device)
    u_hat_ng = u_hat.detach()
    for it in range(iters):
        c = torch.softmax(b, dim=2)                       # over classes j
        u_used = u_hat if it == iters - 1 else u_hat_ng
        v = squash(torch.einsum("bij,bijd->bjd", c, u_used))
        b = b + torch.einsum("bijd,bjd->bij", u_hat_ng, v)
    c = torch.softmax(b, dim=2)
    return squash(torch.einsum("bij,bijd->bjd", c, u_hat))  # v[b, j, d]


def routing_stack_ref(params: Params, u: torch.Tensor,
                      cfg: CapsNetConfig) -> torch.Tensor:
    """Plain walk of the routing-layer graph: squashed primary capsules
    ``u [B, I, C]`` -> class capsules ``[B, J, D]``; residual blocks apply
    the additive coupling, plain layers replace the capsule tensor."""
    stack = cfg.routing_stack()
    h, k = u, 0
    while k < len(stack):
        lay = stack[k]
        if lay.half == "f":
            g_lay = stack[k + 1]
            x1, x2 = h[:, :lay.num_caps], h[:, lay.num_caps:]
            y1 = x1 + routing_by_agreement(
                compute_votes(x2, params[lay.param]), lay.iters)
            y2 = x2 + routing_by_agreement(
                compute_votes(y1, params[g_lay.param]), g_lay.iters)
            h, k = torch.cat([y1, y2], dim=1), k + 2
        else:
            h = routing_by_agreement(
                compute_votes(h, params[lay.param]), lay.iters)
            k += 1
    return h


def decode(params: Params, v: torch.Tensor,
           cfg: CapsNetConfig = CapsNetConfig(), *,
           labels: torch.Tensor | None = None,
           lengths: torch.Tensor | None = None) -> torch.Tensor:
    """Reconstruction decoder over the class capsules masked with
    ``labels`` (training) or the predicted class (inference)."""
    if labels is None:
        if lengths is None:
            lengths = torch.linalg.vector_norm(v, dim=-1)
        labels = torch.argmax(lengths, dim=-1)
    mask = F.one_hot(labels, cfg.num_classes).to(v.dtype)
    masked = (v * mask[..., None]).reshape(v.shape[0], -1)
    h = torch.relu(masked @ params["dec_w1"] + params["dec_b1"])
    h = torch.relu(h @ params["dec_w2"] + params["dec_b2"])
    return torch.sigmoid(h @ params["dec_w3"] + params["dec_b3"])


def _conv_nhwc(x: torch.Tensor, w_hwio: torch.Tensor, b: torch.Tensor,
               stride: int) -> torch.Tensor:
    """VALID convolution in the reference's NHWC / HWIO layouts."""
    out = F.conv2d(x.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1), b,
                   stride=stride)
    return out.permute(0, 2, 3, 1)


def _check_device(params: Params, dev: torch.device) -> None:
    for k, t in params.items():
        if t.device.type != dev.type:
            raise ValueError(f"param {k!r} lies on {t.device}, the forward "
                             f"runs on {dev}; move the params first")


def forward(params: Params, images, cfg: CapsNetConfig = CapsNetConfig(), *,
            labels: torch.Tensor | None = None, backend: str = "torch",
            plan=None, device: str | torch.device = "cuda"
            ) -> dict[str, torch.Tensor]:
    """images: [B, H, W, C] in [0, 1] -> class capsules + reconstruction.

    ``backend="torch"`` is the plain reference.  ``backend="kernels"``
    runs the network through the port's kernels with tiles and the
    routing schedules chosen by an ``ExecutionPlan`` (compiled here with
    ``pipeline=True`` unless ``plan`` is passed): a pipelined plan runs
    Conv1 -> ONE ``primary_routing`` kernel (PrimaryCaps and the first
    routing layer), a per-op plan runs Conv1 -> PrimaryCaps (squash
    fused, or the standalone ``squash`` after it when the plan cannot
    fuse) -> the first routing layer; then each further plain layer is one
    ``votes_routing`` and each run of ResCaps blocks one reversible
    ``res_caps_segment`` (K12).
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; choose from "
                         f"{BACKENDS}")
    dev = resolve_device(device)
    _check_device(params, dev)
    images = torch.as_tensor(images, dtype=torch.float32, device=dev)
    b = images.shape[0]
    if backend == "kernels":
        v = _forward_kernels(params, images, cfg, plan)
    else:
        x = torch.relu(_conv_nhwc(images, params["conv1_w"],
                                  params["conv1_b"], 1))
        x = _conv_nhwc(x, params["pc_w"], params["pc_b"], cfg.pc_stride)
        u = squash(x.reshape(b, cfg.num_primary, cfg.primary_dim))
        v = routing_stack_ref(params, u, cfg)               # [B, J, D]
    lengths = torch.linalg.vector_norm(v, dim=-1)           # class scores
    out = {"class_caps": v, "lengths": lengths}
    if cfg.use_decoder and "dec_w1" in params:
        with obs.span("model.decode"):
            out["reconstruction"] = decode(params, v, cfg, labels=labels,
                                           lengths=lengths)
    return out


def _forward_kernels(params: Params, images: torch.Tensor,
                     cfg: CapsNetConfig, plan) -> torch.Tensor:
    from repro_torch.core import execplan
    from repro_torch.kernels import ops

    b = images.shape[0]
    stack = cfg.routing_stack()
    if plan is None:
        plan = execplan.compile_plan(cfg, batch=b, pipeline=True)
    with obs.span("plan.Conv1"):
        x = ops.conv2d(images, params["conv1_w"], params["conv1_b"],
                       stride=1, plan_op=plan.op("Conv1"),
                       bwd_op=plan.bwd_op("Conv1"), epilogue="relu")

    def w_of(lay: RoutingLayer) -> torch.Tensor:
        return params[lay.param].reshape(lay.in_caps, lay.jd, lay.in_dim)

    if plan.pipelined:
        first = stack[0]
        with obs.span("plan.", execplan.PIPE_NAME):
            h = ops.primary_routing(
                x, params["pc_w"], params["pc_b"], w_of(first), plan=plan,
                stride=cfg.pc_stride, iters=first.iters,
                num_classes=first.num_caps,
                routing_op_name=first.name).reshape(b, first.num_caps,
                                                    first.caps_dim)
        k = 1
    else:
        pc = plan.op("PrimaryCaps")
        with obs.span("plan.PrimaryCaps"):
            x = ops.conv2d(x, params["pc_w"], params["pc_b"],
                           stride=cfg.pc_stride, plan_op=pc,
                           bwd_op=plan.bwd_op("PrimaryCaps"),
                           squash_dim=(cfg.primary_dim if pc.fuses_squash
                                       else 0))
            h, k = x.reshape(b, cfg.num_primary, cfg.primary_dim), 0
            if not pc.fuses_squash:    # no capsule-aligned tile: K10
                h = ops.squash(h, plan=plan)
    # Walk the rest of the routing-layer graph: one votes+routing kernel
    # per plain layer, one reversible segment (K12) per maximal run of
    # residual blocks, its span named by its first op.
    while k < len(stack):
        lay = stack[k]
        if lay.half == "f":
            pairs = []
            while k < len(stack) and stack[k].half == "f":
                pairs.append((stack[k], stack[k + 1]))
                k += 2
            ws = tuple(w_of(lyr) for pair in pairs for lyr in pair)
            with obs.span("plan.", lay.name):
                h = ops.res_caps_segment(h, ws, tuple(pairs), plan=plan)
        else:
            with obs.span("plan.", lay.name):
                h = ops.votes_routing(
                    h, w_of(lay), plan=plan, op_name=lay.name,
                    iters=lay.iters, num_classes=lay.num_caps).reshape(
                        b, lay.num_caps, lay.caps_dim)
            k += 1
    return h


def margin_loss(lengths: torch.Tensor, labels: torch.Tensor,
                m_pos: float = 0.9, m_neg: float = 0.1,
                lam: float = 0.5) -> torch.Tensor:
    """L_k = T_k max(0, m+ - ||v||)^2 + lam (1-T_k) max(0, ||v|| - m-)^2."""
    t = F.one_hot(labels, lengths.shape[-1]).to(lengths.dtype)
    pos = torch.square(torch.clamp(m_pos - lengths, min=0.0))
    neg = torch.square(torch.clamp(lengths - m_neg, min=0.0))
    return torch.mean(torch.sum(t * pos + lam * (1.0 - t) * neg, dim=-1))


def total_loss(params: Params, images, labels,
               cfg: CapsNetConfig = CapsNetConfig(),
               recon_weight: float = 0.0005, *, backend: str = "torch",
               plan=None, device: str | torch.device = "cuda"
               ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """Margin loss + masked reconstruction, differentiable on both
    backends.  The decoder reconstructs the LABELED capsule, so the
    reconstruction term backpropagates only through that capsule's pose.
    On the kernels backend pass a ``compile_plan(train=True)`` plan to pin
    the backward schedules (else the memoized backward decisions apply).
    """
    dev = resolve_device(device)
    images = torch.as_tensor(images, dtype=torch.float32, device=dev)
    labels = torch.as_tensor(labels, device=dev).long()
    out = forward(params, images, cfg, labels=labels, backend=backend,
                  plan=plan, device=dev)
    loss = margin_loss(out["lengths"], labels)
    metrics = {"margin_loss": loss}
    if "reconstruction" in out:
        flat = images.reshape(images.shape[0], -1)
        rec = torch.mean(torch.sum(torch.square(out["reconstruction"]
                                                - flat), -1))
        loss = loss + recon_weight * rec
        metrics["recon_loss"] = rec
    metrics["accuracy"] = torch.mean(
        (torch.argmax(out["lengths"], -1) == labels).to(torch.float32))
    metrics["loss"] = loss
    return loss, metrics


def loss_and_grads(params: Params, images, labels,
                   cfg: CapsNetConfig = CapsNetConfig(), **kw
                   ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """(grads, metrics) of ``total_loss``: one gradient per parameter, in
    ``params``' order, with the metrics detached.  ``kw`` goes to
    ``total_loss``."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    with obs.span("train.forward"):
        loss, metrics = total_loss(leaves, images, labels, cfg, **kw)
    with obs.span("train.backward"):
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    missing = [k for k, g in zip(leaves, grads) if g is None]
    if missing:
        raise RuntimeError(f"total_loss: no gradient reached {missing}")
    return (dict(zip(leaves, grads)),
            {k: v.detach() for k, v in metrics.items()})


def train_step(params: Params, images, labels,
               cfg: CapsNetConfig = CapsNetConfig(), lr: float = 1e-3, *,
               backend: str = "torch", plan=None,
               device: str | torch.device = "cuda"
               ) -> tuple[Params, dict[str, torch.Tensor]]:
    """One SGD step of ``total_loss``.  Updates ``params``' tensors IN
    PLACE (under ``no_grad``) and returns them with the metrics."""
    with obs.span("train.step"):
        grads, metrics = loss_and_grads(params, images, labels, cfg,
                                        backend=backend, plan=plan,
                                        device=device)
        with obs.span("train.update"), torch.no_grad():
            for k, p in params.items():
                p.sub_(lr * grads[k])
    return params, metrics
