"""Checkpoints: atomic, asynchronous, in the reference's on-disk layout.

The counterpart of ``repro/train/checkpoint.py``; one directory per step:

    <dir>/step_000123/
        manifest.json        # keys, shapes, dtypes, step, extras
        arrays.npz           # leaf key -> numpy array
    <dir>/step_000123.COMMIT # empty commit marker (atomicity)

State is a tree of tensors (``{"params": ..., "opt": ...}``): nested
dicts and lists, as the LM's ``prefix`` / ``suffix`` lists
(``repro_torch.tree``).  Leaf keys are the reference's
(``jax.tree_util.keystr`` of the path, e.g. ``['params']['conv1_w']``,
``['params']['prefix'][0]['input_norm']``), so either package restores
the other's checkpoints.  Writes go to ``step_X.tmp`` and are renamed, then
committed, so a preempted writer never leaves a readable but corrupt
checkpoint.  ``AsyncCheckpointer.save_async`` copies the state to host
memory at once and writes it on a background thread.

Sharded state (DTensors, one process a rank): every rank gathers the
full tensors (a collective), rank 0 writes them, and the ranks meet at
a barrier before anyone reads.  ``restore(..., shardings=)`` places
every leaf onto another mesh (elastic restore): a checkpoint written on
one mesh restores onto any other, or onto one process.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as trees
from repro_torch.parallel import compat
from repro_torch.parallel.sharding import full, place


def _to_host(tree):
    """A numpy copy of every leaf, in the tree's structure (a copy, not a
    view: the loop goes on updating its tensors in place); a DTensor
    whole (a collective: every rank calls this)."""
    return trees.tree_map(lambda v: np.array(
        full(torch.as_tensor(v).detach()).cpu(), copy=True), tree)


def _writer() -> bool:
    """Whether this process writes: rank 0 of a process group, or a
    process with none."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _sync() -> None:
    if dist.is_initialized():
        dist.barrier()


def save(tree, directory: str | pathlib.Path, step: int,
         extra: dict | None = None) -> pathlib.Path:
    """Synchronous atomic save (rank 0 writes; every rank returns after
    the write)."""
    directory = pathlib.Path(directory)
    host = _to_host(tree)
    final = directory / f"step_{step:08d}"
    if _writer():
        _write(host, directory, step, extra)
    _sync()
    return final


def _write(host_tree, directory: pathlib.Path, step: int,
           extra: dict | None) -> None:
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    arrays = dict(trees.leaves_with_keys(host_tree))
    np.savez(tmp / "arrays.npz", **arrays)
    manifest = {
        "step": step,
        "keys": list(arrays),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    (directory / f"step_{step:08d}.COMMIT").touch()


class AsyncCheckpointer:
    """Snapshot now, write later; at most one write in flight."""

    def __init__(self, directory: str | pathlib.Path, keep: int = 3):
        self.directory = pathlib.Path(directory)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.last_error: Exception | None = None

    def save_async(self, tree, step: int,
                   extra: dict | None = None) -> None:
        self.wait()
        host_tree = _to_host(tree)                       # snapshot
        if not _writer():
            return

        def _run():
            try:
                _write(host_tree, self.directory, step, extra)
                self._gc()
            except Exception as e:                      # pragma: no cover
                self.last_error = e                     # raised by wait()

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Until the write in flight is committed (on every rank)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        _sync()
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def _gc(self) -> None:
        steps = committed_steps(self.directory)
        for s in steps[:-self.keep]:
            shutil.rmtree(self.directory / f"step_{s:08d}",
                          ignore_errors=True)
            (self.directory / f"step_{s:08d}.COMMIT").unlink(missing_ok=True)


def committed_steps(directory: str | pathlib.Path) -> list[int]:
    directory = pathlib.Path(directory)
    if not directory.exists():
        return []
    out = []
    for marker in directory.glob("step_*.COMMIT"):
        s = int(marker.stem.split("_")[1])
        if (directory / f"step_{s:08d}" / "manifest.json").exists():
            out.append(s)
    return sorted(out)


def latest_step(directory: str | pathlib.Path) -> int | None:
    steps = committed_steps(directory)
    return steps[-1] if steps else None


def restore(template, directory: str | pathlib.Path,
            step: int | None = None, shardings=None) -> tuple[dict, dict]:
    """Restore into the structure of ``template`` (a tree of tensors:
    dicts and lists, empty ones included): each leaf comes back with the
    template leaf's dtype and device.  ``shardings`` (a tree of the
    template's structure of ``parallel.sharding.NamedSharding`` or None)
    places each leaf onto its mesh -- the elastic restore; without it a
    DTensor leaf keeps the template's placements.  Returns ``(tree,
    manifest)``."""
    directory = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    d = directory / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    with np.load(d / "arrays.npz") as arrays:
        def rebuild(tmpl, key: str, shard):
            if isinstance(tmpl, dict):
                return {k: rebuild(v, f"{key}[{k!r}]",
                                   None if shard is None else shard[k])
                        for k, v in tmpl.items()}
            if isinstance(tmpl, (list, tuple)):
                return [rebuild(v, f"{key}[{i}]",
                                None if shard is None else shard[i])
                        for i, v in enumerate(tmpl)]
            if key not in arrays:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = arrays[key]
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ValueError(f"shape mismatch for {key}: "
                                 f"{arr.shape} vs {tuple(tmpl.shape)}")
            out = torch.tensor(arr, dtype=tmpl.dtype, device=tmpl.device)
            if shard is None and compat.is_dtensor(tmpl):
                return compat.distribute_tensor(out, tmpl.device_mesh,
                                                tmpl.placements)
            return place(out, shard)

        return rebuild(template, "", shardings), manifest
