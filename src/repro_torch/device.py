"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The ``torch.device`` an entry point runs on.

    CUDA is the default; without a card this raises instead of quietly
    running on the CPU -- the caller asks for ``device="cpu"`` (the plain
    PyTorch twins of every kernel) explicitly.  ``"meta"`` builds shapes
    and dtypes without memory (``launch/shapes.py``).  On CUDA it also
    turns TF32 off for cuBLAS and cuDNN: the port computes in IEEE fp32,
    as the reference does, and a TF32 result would miss its tolerances.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: no CUDA device is available; pass device='cpu' "
                "to run the plain PyTorch versions of the kernels")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu' (or 'meta' "
                         f"for shapes alone), not {dev}")
    return dev
