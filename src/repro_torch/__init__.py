"""CapStore's CapsuleNet in PyTorch, with hand-written CUDA kernels for Hopper.

The port of ``repro`` (JAX/Pallas on a TPU) to PyTorch on an NVIDIA H100.
The layout mirrors ``repro`` so each module has an obvious counterpart:
``core`` (model, planner, execution plan), ``kernels`` (CUDA kernels, each
with a plain PyTorch twin), ``serve`` (the slot-batched engine) and
``configs``.  Entry points run on ``device="cuda"`` unless the caller asks
for ``device="cpu"``, where every kernel wrapper runs its plain twin.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
