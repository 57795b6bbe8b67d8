"""Work counted from a configuration's shapes: FLOPs and bytes per image.

The count is the algorithm's, whatever kernel implements it: a kernel
that recomputes (a streamed schedule's votes) or reads a byte twice does
more work than is counted here, never less.  A frozen copy of the
arithmetic of the port's chip checks (``routing_flops``,
``routing_bwd_flops``, ``bound``), with the H100 SXM's published peaks.

Bytes: each input byte read once and each output byte written once, for
the whole forward (or step) as one piece of work: the images and the
parameters read, the lengths written (serving); the images, labels and
parameters read and the parameters written (an SGD step).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet (dense, no sparsity), at its 700 W limit.
PEAK_FP32_FLOPS = 67e12         # fp32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12
F32 = 4


def conv1_out(cfg: dict) -> int:
    return cfg["image_hw"] - cfg["conv1_kernel"] + 1


def pc_out(cfg: dict) -> int:
    return (conv1_out(cfg) - cfg["pc_kernel"]) // cfg["pc_stride"] + 1


def routing_flops(b, i, c, jd, iters) -> float:
    """Votes once, then each routing pass's couplings and s."""
    return 2.0 * b * i * jd * (c + 2 * iters + 1)


def routing_bwd_flops(b, i, c, jd, iters) -> float:
    """The routing backward's own work: the votes once, the replayed
    routing, the seed/reverse rows and the du/dW emit."""
    votes = 2.0 * b * i * jd * c
    route = (iters + 1) * 4.0 * b * i * jd + 6.0 * b * i * jd
    emit = 3.0 * b * i * jd + 4.0 * b * i * jd * c
    return votes + route + emit


def bound_s(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the chip could take, and which peak bounds it."""
    t_ops = flops / PEAK_FP32_FLOPS
    t_bytes = nbytes / PEAK_HBM_BYTES
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def conv1_flops(cfg: dict) -> float:
    """Conv1 per image: 2 x output positions x (k*k*C_in) x channels."""
    return (2.0 * conv1_out(cfg) ** 2 * cfg["conv1_kernel"] ** 2
            * cfg["in_channels"] * cfg["conv1_channels"])


def primary_flops(cfg: dict) -> float:
    """PrimaryCaps per image: the conv's multiply-adds."""
    return (2.0 * pc_out(cfg) ** 2 * cfg["pc_kernel"] ** 2
            * cfg["conv1_channels"] * cfg["num_primary_groups"]
            * cfg["primary_dim"])


def routing_shapes(cfg: dict) -> list[tuple[int, int, int, int]]:
    """``(I, C, J*D, iters)`` of every votes+routing layer, in order (a
    residual block is its two halves)."""
    i, c = pc_out(cfg) ** 2 * cfg["num_primary_groups"], cfg["primary_dim"]
    out = []
    for entry in cfg.get("caps_layers", []):
        it = entry.get("routing_iters", 3)
        if entry["kind"] == "rescaps":
            i1, i2 = i // 2, i - i // 2
            out.append((i2, c, i1 * c, it))
            out.append((i1, c, i2 * c, it))
        else:
            out.append((i, c, entry["num_caps"] * entry["caps_dim"], it))
            i, c = entry["num_caps"], entry["caps_dim"]
    out.append((i, c, cfg["num_classes"] * cfg["class_dim"],
                cfg["routing_iters"]))
    return out


def votes_flops(cfg: dict) -> float:
    """The first routing layer's votes per image."""
    i, c, jd, _ = routing_shapes(cfg)[0]
    return 2.0 * i * jd * c


def decoder_flops(cfg: dict) -> float:
    """The decoder's three matmuls per image (forward)."""
    h1, h2 = cfg["decoder_hidden"]
    d_in = cfg["num_classes"] * cfg["class_dim"]
    d_out = cfg["image_hw"] ** 2 * cfg["in_channels"]
    return 2.0 * (d_in * h1 + h1 * h2 + h2 * d_out)


def param_count(cfg: dict, decoder: bool) -> int:
    k1, k2, ch = cfg["conv1_kernel"], cfg["pc_kernel"], cfg["conv1_channels"]
    pcc = cfg["num_primary_groups"] * cfg["primary_dim"]
    n = k1 * k1 * cfg["in_channels"] * ch + ch + k2 * k2 * ch * pcc + pcc
    n += sum(i * jd * c for i, c, jd, _ in routing_shapes(cfg))
    if decoder:
        h1, h2 = cfg["decoder_hidden"]
        d_in = cfg["num_classes"] * cfg["class_dim"]
        d_out = cfg["image_hw"] ** 2 * cfg["in_channels"]
        n += d_in * h1 + h1 + h1 * h2 + h2 + h2 * d_out + d_out
    return n


def image_elems(cfg: dict) -> int:
    return cfg["image_hw"] ** 2 * cfg["in_channels"]


def serve_flops(cfg: dict) -> float:
    """FLOPs of one served image: Conv1, PrimaryCaps and every routing
    layer (votes and passes).  The decoder is not counted: the engine
    throws its reconstruction away."""
    return (conv1_flops(cfg) + primary_flops(cfg)
            + sum(routing_flops(1, i, c, jd, it)
                  for i, c, jd, it in routing_shapes(cfg)))


def serve_bytes(cfg: dict, batch: int) -> float:
    """Bytes of one forward over ``batch`` images: the images and the
    serving parameters read once, the lengths written once."""
    return F32 * (batch * image_elems(cfg) + param_count(cfg, decoder=False)
                  + batch * cfg["num_classes"])


def train_flops(cfg: dict) -> float:
    """FLOPs of one training sample: the forward, the decoder, the margin
    and reconstruction loss, and their gradients.  A matmul's backward is
    its two products (dW and dX; Conv1's dX is not needed: its input is
    the images); a routing layer's backward is ``routing_bwd_flops``; the
    losses are a few elementwise operations a class and a pixel."""
    fwd = serve_flops(cfg) + decoder_flops(cfg)
    bwd = (conv1_flops(cfg) + 2.0 * primary_flops(cfg)
           + sum(routing_bwd_flops(1, i, c, jd, it)
                 for i, c, jd, it in routing_shapes(cfg))
           + 2.0 * decoder_flops(cfg))
    losses = 8.0 * cfg["num_classes"] + 3.0 * image_elems(cfg)
    return fwd + bwd + 2.0 * losses


def train_bytes(cfg: dict, batch: int) -> float:
    """Bytes of one SGD step: the images and labels read, every parameter
    read and written once."""
    return (F32 * batch * image_elems(cfg) + 8 * batch
            + 2 * F32 * param_count(cfg, decoder=True))
