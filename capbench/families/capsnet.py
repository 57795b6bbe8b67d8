"""The CapsuleNet family (``configs/capsnet-*.json``): the weights and
images of ``capbench.inputs``, and the configuration as ``repro_torch``'s
``CapsNetConfig``."""

from __future__ import annotations

import torch

from capbench import inputs

# The port's CUDA libraries that CapsuleNet's forward and backward load.
LIBRARIES = ("conv_im2col", "primary_routing", "votes_routing",
             "conv_bwd", "votes_routing_bwd")

weights = inputs.weights
program_config = inputs.program_config


def pool(cfg: dict, params: dict, seed: int, device: torch.device) -> dict:
    """``params["pool"]`` images and their labels."""
    x, y = inputs.images(cfg, params["pool"], seed, device)
    return {"images": x, "labels": y}
