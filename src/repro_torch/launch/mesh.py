"""Production meshes: the counterpart of ``repro/launch/mesh.py``.

Defined as FUNCTIONS so importing this module never touches a process
group.  A ``DeviceMesh`` is made only when one exists
(``torch.distributed.is_initialized()``) and spans exactly the mesh's
ranks; otherwise these return an ``AbstractMesh``, the axis sizes alone,
which is all the sharding rules read (``parallel.sharding``), so the
rules of a 256- or 512-rank mesh are computed on one process.
"""

from __future__ import annotations

import dataclasses
import math

import torch.distributed as dist

from repro_torch.parallel import compat


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Named axis sizes with no devices behind them."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...],
          device_type: str):
    if dist.is_initialized() and dist.get_world_size() == math.prod(shape):
        return compat.make_mesh(device_type, shape, axes)
    return AbstractMesh(axes, shape)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16x16 single pod (256 ranks) or 2x16x16 (2 pods, 512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, device_type)


def make_debug_mesh(data: int = 2, model: int = 2, pod: int | None = None,
                    *, device_type: str = "cpu"):
    """Small mesh for the multi-rank CPU tests (gloo ranks)."""
    if pod:
        return _mesh((pod, data, model), ("pod", "data", "model"),
                     device_type)
    return _mesh((data, model), ("data", "model"), device_type)


def mesh_chips(mesh) -> int:
    sizes = (mesh.sizes if isinstance(mesh, AbstractMesh)
             else tuple(mesh.shape))
    return math.prod(sizes)
