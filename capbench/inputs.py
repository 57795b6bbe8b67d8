"""What a run hands the system under test and the reference alike: the
weights and the images, drawn on the device from ``--seed``, and the
configuration in the program's own type.

Weights follow the parameter names and shapes of
``repro_torch.core.capsnet`` (``reference.capsnet_ref.param_shapes``
lists them): one normal draw for all of them, cut into leaves and scaled
by He's law (``sqrt(2 / fan_in)``) for conv and decoder weights, 0.1 for
routing weights (the program's own init), 0.01 for biases (so that the
comparison sees them).  Images are uniform in [0, 1], labels uniform
over the classes: a pool the traffic draws from, no dataset.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from capbench.reference import capsnet_ref

SEED_MASK = (1 << 63) - 1


def generator(seed: int, device: torch.device, stream: int) -> torch.Generator:
    """A generator on ``device`` for one purpose (``stream``) of a run:
    the same ``seed`` gives the same numbers."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) & SEED_MASK)
    return g


def np_rng(seed: int, stream: int = 0) -> np.random.Generator:
    """A host generator for one purpose (``stream``) of a run."""
    return np.random.default_rng([int(seed) & SEED_MASK, stream])


def weights(cfg: dict, seed: int, device: torch.device) -> dict:
    shapes = capsnet_ref.param_shapes(cfg)
    sizes = [math.prod(s) for s, _ in shapes.values()]
    flat = torch.randn(sum(sizes), generator=generator(seed, device, 1),
                       device=device)
    out, at = {}, 0
    for (name, (shape, fan_in)), n in zip(shapes.items(), sizes):
        if name.startswith("cc"):
            std = 0.1
        elif fan_in == 0:
            std = 0.01
        else:
            std = math.sqrt(2.0 / fan_in)
        out[name] = (flat[at:at + n] * std).reshape(shape)
        at += n
    return out


def images(cfg: dict, n: int, seed: int, device: torch.device
           ) -> tuple[torch.Tensor, torch.Tensor]:
    """A pool of ``n`` images ``[n, H, W, C]`` and their labels."""
    hw, ch = cfg["image_hw"], cfg["in_channels"]
    g = generator(seed, device, 2)
    x = torch.rand((n, hw, hw, ch), generator=g, device=device)
    y = torch.randint(0, cfg["num_classes"], (n,), generator=g, device=device)
    return x, y


def program_config(cfg: dict):
    """The configuration as ``repro_torch``'s ``CapsNetConfig``."""
    from repro_torch.core.capsnet import (CapsLayerSpec, CapsNetConfig,
                                          ResCapsBlock)
    layers = []
    for e in cfg.get("caps_layers", []):
        it = e.get("routing_iters", 3)
        if e["kind"] == "rescaps":
            layers.append(ResCapsBlock(routing_iters=it))
        else:
            layers.append(CapsLayerSpec(num_caps=e["num_caps"],
                                        caps_dim=e["caps_dim"],
                                        routing_iters=it))
    keys = ("image_hw", "in_channels", "conv1_channels", "conv1_kernel",
            "pc_kernel", "pc_stride", "num_primary_groups", "primary_dim",
            "num_classes", "class_dim", "routing_iters", "use_decoder")
    return CapsNetConfig(**{k: cfg[k] for k in keys},
                         decoder_hidden=tuple(cfg["decoder_hidden"]),
                         caps_layers=tuple(layers))


def smoke(cfg: dict) -> dict:
    """The configuration at its ``smoke`` sizes (the CPU tests' own)."""
    out = {k: v for k, v in cfg.items() if k != "smoke"}
    out.update(cfg["smoke"])
    return out
