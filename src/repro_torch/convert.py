"""Move the reference's parameters into the port.

The port keeps the reference's layouts (conv weights HWIO, ``cc_w``
``[I, J, D, C]``; the LM tree with its stacked ``[repeats, ...]`` pattern
leaves and ``[d_in, d_out]`` projections, MoE experts ``[E, d, f]``
stacked ``[repeats, E, d, f]``), so conversion is a copy with no
transposes.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree
from repro_torch.device import resolve_device


def params_from_numpy(np_params: dict, device: str | torch.device = "cuda"
                      ) -> dict[str, torch.Tensor]:
    """``{name: array}`` (the reference's ``init_params`` output taken
    through ``np.asarray``) -> the port's ``{name: float32 tensor}``."""
    dev = resolve_device(device)
    return {k: torch.tensor(np.asarray(v, np.float32), device=dev)
            for k, v in np_params.items()}


def opt_state_from_numpy(np_state: dict, device: str | torch.device = "cuda"
                         ) -> dict:
    """The reference's AdamW state (``{"m": ..., "v": ..., "step"}``, its
    leaves taken through ``np.asarray``; m and v flat dicts (CapsuleNet)
    or LM trees of dicts and lists) -> the port's ``init_opt_state``
    layout: float32 moments in the same tree and an int32 0-d step."""
    dev = resolve_device(device)

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    return {"m": tree.tree_map(f32, np_state["m"]),
            "v": tree.tree_map(f32, np_state["v"]),
            "step": torch.tensor(np.asarray(np_state["step"], np.int32),
                                 device=dev)}


def _lm_leaf(a, dev: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes: exact through fp32
        return torch.tensor(a.astype(np.float32),
                            device=dev).to(torch.bfloat16)
    return torch.tensor(a, device=dev)


def lm_params_from_numpy(params, device: str | torch.device = "cuda"):
    """The reference's LM parameter tree (``repro.models.init_model``, its
    leaves taken through ``np.asarray``: nested dicts and lists; dense,
    MoE, MLA and Mamba blocks, the ``shared`` branch with its ``{}``
    pattern slots, ``frontend_proj``) -> the same tree of tensors of the
    same types on ``device``."""
    dev = resolve_device(device)
    return tree.tree_map(lambda a: _lm_leaf(a, dev), params)
