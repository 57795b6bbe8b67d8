"""Move the reference's parameters into the port.

The port keeps the reference's layouts (conv weights HWIO, ``cc_w``
``[I, J, D, C]``), so conversion is a copy with no transposes.
"""

from __future__ import annotations

import numpy as np
import torch

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
    """The reference's AdamW state (``{"m": {...}, "v": {...}, "step"}``
    taken through ``np.asarray``) -> the port's ``init_opt_state`` layout:
    float32 moments and an int32 0-d step."""
    dev = resolve_device(device)
    return {"m": params_from_numpy(np_state["m"], dev),
            "v": params_from_numpy(np_state["v"], dev),
            "step": torch.tensor(np.asarray(np_state["step"], np.int32),
                                 device=dev)}
