"""Plain fp32 CapsuleNet in PyTorch: the benchmark's reference.

Sabour et al. 2017 ("Dynamic Routing Between Capsules", arXiv:1710.09829):
Conv1 (ReLU) -> PrimaryCaps (conv, squash per capsule) -> routing layers
(votes, then routing-by-agreement) -> capsule lengths; the decoder
reconstructs the labelled capsule; the loss is the margin loss plus the
weighted reconstruction error.  Deep stacks insert plain routing layers
and reversible residual blocks (``y1 = x1 + F(x2)``, ``y2 = x2 + G(y1)``)
between PrimaryCaps and the class capsules.

A configuration is the plain dict of its JSON file (``capbench/configs``).
Layouts: images NHWC, conv weights HWIO, a routing layer's weight
``[I, J, D, C]``.  Routing keeps the stop-gradient convention of the
system under test: the logit updates see a detached copy of the votes,
and only the last pass's ``s`` carries their gradient.

Everything runs in IEEE fp32 with TF32 off, except under
``Precision("tf32")``, the control: on the card cuBLAS and cuDNN compute
every matmul and convolution in TF32 (``Precision.context``); on the CPU,
which has no TF32, every such operand is rounded to TF32's 10-bit
mantissa instead, as the tensor cores round them (the gradient passes
through the rounding unchanged).  This module imports nothing of the
system under test.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

EPS = 1e-7


class Precision:
    """How the reference's products are computed: ``"fp32"`` (IEEE, TF32
    off) or ``"tf32"`` (the control).  Call it on each matmul or
    convolution operand, and run the computation inside ``context()``."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "tf32"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode == "fp32" or x.is_cuda:
            return x
        r = round_tf32(x.detach())
        return x + (r - x.detach())

    @contextlib.contextmanager
    def context(self):
        """cuBLAS's and cuDNN's TF32 switches set for this precision inside
        the block, restored after."""
        on = self.mode == "tf32"
        old = (torch.backends.cuda.matmul.allow_tf32,
               torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = old


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (1 sign, 8 exponent, 10 mantissa bits),
    to nearest, ties to even: the 13 low mantissa bits of fp32 cleared."""
    bits = x.contiguous().view(torch.int32)
    low = bits & 0x1FFF
    keep = bits & ~0x1FFF
    half = 0x1000
    odd = (keep >> 13) & 1
    up = (low > half) | ((low == half) & (odd == 1))
    return torch.where(up, keep + 0x2000, keep).view(torch.float32)


def conv1_out(cfg: dict) -> int:
    return cfg["image_hw"] - cfg["conv1_kernel"] + 1


def pc_out(cfg: dict) -> int:
    return (conv1_out(cfg) - cfg["pc_kernel"]) // cfg["pc_stride"] + 1


def num_primary(cfg: dict) -> int:
    return pc_out(cfg) ** 2 * cfg["num_primary_groups"]


def routing_layers(cfg: dict) -> list[dict]:
    """The chain of routing layers, in order: each with its parameter
    name, in/out capsule counts and dimensions, passes, and ``half``
    ("f", "g" for the halves of a residual block, None for a plain
    layer).  Parameter names are ``cc<k>_w`` in order, ``cc_w`` last."""
    out: list[dict] = []
    i, c = num_primary(cfg), cfg["primary_dim"]
    for entry in cfg.get("caps_layers", []):
        it = entry.get("routing_iters", 3)
        if entry["kind"] == "rescaps":
            i1, i2 = i // 2, i - i // 2
            out.append(dict(param=f"cc{len(out)}_w", in_caps=i2, in_dim=c,
                            num_caps=i1, caps_dim=c, iters=it, half="f"))
            out.append(dict(param=f"cc{len(out)}_w", in_caps=i1, in_dim=c,
                            num_caps=i2, caps_dim=c, iters=it, half="g"))
        elif entry["kind"] == "caps":
            out.append(dict(param=f"cc{len(out)}_w", in_caps=i, in_dim=c,
                            num_caps=entry["num_caps"],
                            caps_dim=entry["caps_dim"], iters=it, half=None))
            i, c = entry["num_caps"], entry["caps_dim"]
        else:
            raise ValueError(f"unknown caps layer kind {entry['kind']!r}")
    out.append(dict(param="cc_w", in_caps=i, in_dim=c,
                    num_caps=cfg["num_classes"], caps_dim=cfg["class_dim"],
                    iters=cfg["routing_iters"], half=None))
    return out


def param_shapes(cfg: dict) -> dict[str, tuple[tuple[int, ...], int]]:
    """Each parameter's shape and fan-in (0 for a bias), in order."""
    k1, k2, ch = cfg["conv1_kernel"], cfg["pc_kernel"], cfg["conv1_channels"]
    pcc = cfg["num_primary_groups"] * cfg["primary_dim"]
    shapes = {
        "conv1_w": ((k1, k1, cfg["in_channels"], ch), k1 * k1 * cfg["in_channels"]),
        "conv1_b": ((ch,), 0),
        "pc_w": ((k2, k2, ch, pcc), k2 * k2 * ch),
        "pc_b": ((pcc,), 0),
    }
    for lay in routing_layers(cfg):
        shapes[lay["param"]] = ((lay["in_caps"], lay["num_caps"],
                                 lay["caps_dim"], lay["in_dim"]), lay["in_dim"])
    if cfg.get("use_decoder", True):
        d_in = cfg["num_classes"] * cfg["class_dim"]
        h1, h2 = cfg["decoder_hidden"]
        d_out = cfg["image_hw"] ** 2 * cfg["in_channels"]
        for n, (a, b) in enumerate(((d_in, h1), (h1, h2), (h2, d_out)), 1):
            shapes[f"dec_w{n}"] = ((a, b), a)
            shapes[f"dec_b{n}"] = ((b,), 0)
    return shapes


def squash(s: torch.Tensor) -> torch.Tensor:
    sq = torch.sum(s * s, dim=-1, keepdim=True)
    return (sq / (1.0 + sq)) * s * torch.rsqrt(sq + EPS)


def conv(x, w, b, stride: int, p: Precision):
    """VALID convolution, NHWC input, HWIO weight."""
    out = F.conv2d(p(x).permute(0, 3, 1, 2), p(w).permute(3, 2, 0, 1), b,
                   stride=stride)
    return out.permute(0, 2, 3, 1)


def route(u: torch.Tensor, w: torch.Tensor, iters: int,
          p: Precision) -> torch.Tensor:
    """Votes ``u_hat[b,i,j,d] = W[i,j,d,c] u[b,i,c]`` and dynamic routing
    over them: ``u [B, I, C]`` -> ``v [B, J, D]``."""
    u_hat = torch.einsum("bic,ijdc->bijd", p(u), p(w))
    ng = u_hat.detach()
    logits = torch.zeros(u_hat.shape[:3], dtype=u_hat.dtype,
                         device=u_hat.device)
    for it in range(iters):
        c = torch.softmax(logits, dim=2)
        used = u_hat if it == iters - 1 else ng
        v = squash(torch.einsum("bij,bijd->bjd", p(c), p(used)))
        logits = logits + torch.einsum("bijd,bjd->bij", p(ng), p(v))
    c = torch.softmax(logits, dim=2)
    return squash(torch.einsum("bij,bijd->bjd", p(c), p(u_hat)))


def class_caps(params: dict, images: torch.Tensor, cfg: dict,
               p: Precision = Precision()) -> torch.Tensor:
    """Images ``[B, H, W, C]`` -> class capsules ``[B, J, D]``."""
    x = torch.relu(conv(images, params["conv1_w"], params["conv1_b"], 1, p))
    x = conv(x, params["pc_w"], params["pc_b"], cfg["pc_stride"], p)
    h = squash(x.reshape(images.shape[0], num_primary(cfg),
                         cfg["primary_dim"]))
    layers = routing_layers(cfg)
    k = 0
    while k < len(layers):
        lay = layers[k]
        if lay["half"] == "f":
            g = layers[k + 1]
            x1, x2 = h[:, :lay["num_caps"]], h[:, lay["num_caps"]:]
            y1 = x1 + route(x2, params[lay["param"]], lay["iters"], p)
            y2 = x2 + route(y1, params[g["param"]], g["iters"], p)
            h, k = torch.cat([y1, y2], dim=1), k + 2
        else:
            h, k = route(h, params[lay["param"]], lay["iters"], p), k + 1
    return h


def lengths(params: dict, images: torch.Tensor, cfg: dict,
            p: Precision = Precision()) -> torch.Tensor:
    """The served answer: each class capsule's length ``[B, J]``."""
    return torch.linalg.vector_norm(class_caps(params, images, cfg, p),
                                    dim=-1)


def loss(params: dict, images: torch.Tensor, labels: torch.Tensor, cfg: dict,
         p: Precision = Precision(), recon_weight: float = 0.0005,
         m_pos: float = 0.9, m_neg: float = 0.1,
         lam: float = 0.5) -> torch.Tensor:
    """Margin loss + ``recon_weight`` x the summed squared reconstruction
    error of the decoder over the labelled capsule, batch means."""
    v = class_caps(params, images, cfg, p)
    ln = torch.linalg.vector_norm(v, dim=-1)
    t = F.one_hot(labels, cfg["num_classes"]).to(ln.dtype)
    margin = torch.mean(torch.sum(
        t * torch.square(torch.clamp(m_pos - ln, min=0.0))
        + lam * (1.0 - t) * torch.square(torch.clamp(ln - m_neg, min=0.0)),
        dim=-1))
    if not cfg.get("use_decoder", True):
        return margin
    h = (v * t[..., None]).reshape(v.shape[0], -1)
    h = torch.relu(p(h) @ p(params["dec_w1"]) + params["dec_b1"])
    h = torch.relu(p(h) @ p(params["dec_w2"]) + params["dec_b2"])
    rec = torch.sigmoid(p(h) @ p(params["dec_w3"]) + params["dec_b3"])
    err = torch.mean(torch.sum(torch.square(
        rec - images.reshape(images.shape[0], -1)), dim=-1))
    return margin + recon_weight * err


def sgd_step(params: dict, images: torch.Tensor, labels: torch.Tensor,
             cfg: dict, lr: float, p: Precision = Precision()
             ) -> tuple[dict, dict, float]:
    """One SGD step: the new parameters (new tensors), the gradients and
    the loss."""
    leaves = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    value = loss(leaves, images, labels, cfg, p)
    grads = torch.autograd.grad(value, list(leaves.values()))
    grads = dict(zip(leaves, grads))
    with torch.no_grad():
        new = {k: v.detach() - lr * grads[k] for k, v in leaves.items()}
    return new, grads, float(value.detach())
