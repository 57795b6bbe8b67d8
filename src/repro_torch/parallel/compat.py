"""Version shims for the ``torch.distributed`` APIs that moved between
releases: the counterpart of ``repro/parallel/compat.py``.

  * ``all_gather_single`` / ``reduce_scatter_single`` (newer) vs
    ``all_gather_into_tensor`` / ``reduce_scatter_tensor`` (older; the
    newer torch warns that the old names are deprecated);
  * ``torch.distributed.tensor`` (public since 2.4) vs
    ``torch.distributed._tensor``;
  * ``init_device_mesh`` vs the ``DeviceMesh`` constructor;
  * ``implicit_replication`` that nests;
  * ``fake_store``: the fake process group, from a private module.

Nothing here touches a process group at import time.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

try:                                                    # torch >= 2.4
    from torch.distributed import tensor as dtensor
except ImportError:                                     # pragma: no cover
    from torch.distributed import _tensor as dtensor

DTensor = dtensor.DTensor
Shard = dtensor.Shard
Replicate = dtensor.Replicate
Partial = dtensor.Partial
distribute_tensor = dtensor.distribute_tensor



@contextlib.contextmanager
def implicit_replication():
    """Plain tensors meet DTensors as replicated inside the block.
    ``torch.distributed.tensor.experimental.implicit_replication`` resets
    the flag to False on exit, which ends an enclosing block too; this
    one restores what it found, so blocks nest."""
    dispatcher = getattr(DTensor, "_op_dispatcher", None)
    if dispatcher is None or not hasattr(
            dispatcher, "_allow_implicit_replication"):  # pragma: no cover
        from torch.distributed.tensor.experimental import (
            implicit_replication as fallback)
        with fallback():
            yield
        return
    prev = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = prev


def all_gather_single(out: torch.Tensor, inp: torch.Tensor, group=None
                      ) -> None:
    """Gather ``inp`` of every rank of ``group`` into ``out`` (concatenated
    along dim 0)."""
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, inp, group=group)


def reduce_scatter_single(out: torch.Tensor, inp: torch.Tensor,
                          group=None) -> None:
    """Sum ``inp`` over ``group`` and keep this rank's dim-0 chunk in
    ``out``."""
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    fn(out, inp, group=group)


def fake_store():
    """The store of torch's fake process-group backend (``"fake"``: every
    collective returns at once, nothing is sent), which the dry run uses
    to build a production mesh in one process.  It lives in a private
    module (``torch.testing._internal.distributed.fake_pg``, whose import
    registers the backend); a torch without it raises here."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:                            # pragma: no cover
        raise ImportError(
            "the dry run needs torch's fake process group "
            "(torch.testing._internal.distributed.fake_pg), which this "
            f"torch {torch.__version__} does not have") from e
    return FakeStore()


def make_mesh(device_type: str, shape: tuple[int, ...],
              axis_names: tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` over the ranks of the default process
    group, with named dims."""
    try:
        from torch.distributed.device_mesh import init_device_mesh
    except ImportError:                                 # pragma: no cover
        from torch.distributed._tensor import DeviceMesh
        ranks = torch.arange(dist.get_world_size()).reshape(shape)
        return DeviceMesh(device_type, ranks, mesh_dim_names=axis_names)
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)
