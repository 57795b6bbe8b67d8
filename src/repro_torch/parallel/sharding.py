"""Logical sharding rules -> specs for parameters, activations and caches,
and the serving slot mesh: the counterpart of
``repro/parallel/sharding.py`` over ``torch.distributed``.

Mesh axes: ``("data", "model")`` single-pod, ``("pod", "data", "model")``
multi-pod.  ``pod`` composes with ``data`` for pure data parallelism.

Parallelism schemes expressed here:
  * TP (Megatron): attention heads / d_ff / experts / vocab over ``model``;
  * SP (sequence parallelism): the residual stream between blocks is
    sharded over ``model`` on the *sequence* dim (``sp=True``);
  * EP: MoE expert dim over ``model``;
  * KV cache: ``kv_mode="heads"`` shards the cache over KV heads or
    ``kv_mode="seq"`` over the sequence dim (flash-decoding style).

A spec is a ``P``: a tuple with one entry per tensor dim, each an axis
name, a tuple of axis names or None -- the reference's ``PartitionSpec``
as a plain tuple, so the two compare equal entry for entry.  A mesh is a
``DeviceMesh`` with named dims, or anything whose ``shape`` maps axis
names to sizes (``launch.mesh.AbstractMesh``): the rules read only the
sizes, so they are pure functions of the shapes.  ``to_placements`` turns
a spec into DTensor placements (``Shard(dim)`` / ``Replicate()``) on a
``DeviceMesh``; ``ShardingCtx.act`` redistributes an activation to its
rule's placements, the counterpart of ``with_sharding_constraint``.

The serving mesh (``slot_mesh``) has no ``shard_map``: a shard is a
device holding a replica of the parameters and its block of the slot
batch (``serve/capsule.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any

import torch

from repro_torch import tree as trees
from repro_torch.parallel import compat


class P(tuple):
    """A partition spec: one entry a tensor dim (axis name, tuple of axis
    names, or None); fewer entries than dims leave the rest unsharded.  A
    one-name tuple is stored as the name, as ``PartitionSpec`` does."""

    def __new__(cls, *axes):
        return super().__new__(cls, (
            a[0] if isinstance(a, tuple) and len(a) == 1 else a
            for a in axes))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


# ---------------------------------------------------------------------------
# Slot-shard axis for the CapsuleEngine serving mesh
# ---------------------------------------------------------------------------

# The serving mesh is 1-D: slot s lives on shard s // slots_per_shard,
# params are replicated on every shard.
SLOT_AXIS = "shards"


def slot_mesh(n_shards: int, device: str | torch.device = "cuda"
              ) -> list[torch.device]:
    """The serving mesh: one device a shard.  On CUDA the first
    ``n_shards`` visible devices (a ``ValueError`` past
    ``torch.cuda.device_count()``); on ``device="cpu"`` every shard is the
    CPU -- the counterpart of the reference's forced host devices, so the
    sharded engine's logic runs on any machine."""
    dev = torch.device(device)
    if dev.type == "cpu":
        if n_shards < 1:
            raise ValueError(f"n_shards={n_shards} must be >= 1")
        return [dev] * n_shards
    n_dev = torch.cuda.device_count()
    if not 1 <= n_shards <= n_dev:
        raise ValueError(
            f"n_shards={n_shards} needs 1..{n_dev} of the visible CUDA "
            f"devices ({n_dev} visible); run on device='cpu' for a CPU mesh")
    return [torch.device("cuda", i) for i in range(n_shards)]


def slot_batch_spec() -> P:
    """Spec for slot-major tensors: rows sharded over ``SLOT_AXIS``."""
    return P(SLOT_AXIS)


def slot_param_spec() -> P:
    """Params are replicated across the serving mesh."""
    return P()


# ---------------------------------------------------------------------------
# Meshes and placements
# ---------------------------------------------------------------------------

def axis_sizes(mesh) -> dict[str, int]:
    """Axis name -> size of a ``DeviceMesh`` or an abstract mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return dict(mesh.shape)


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def axes_size(mesh, axes) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in _axes(axes):
        n *= sizes[a]
    return n


def to_placements(spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh`` (a ``DeviceMesh``): one
    a mesh dim, ``Shard(d)`` where tensor dim d names that axis, else
    ``Replicate()``."""
    names = list(mesh.mesh_dim_names)
    out = [compat.Replicate() for _ in names]
    for d, entry in enumerate(spec):
        for a in _axes(entry):
            out[names.index(a)] = compat.Shard(d)
    return out


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the reference's ``NamedSharding``."""

    mesh: Any
    spec: P

    def placements(self) -> list:
        return to_placements(self.spec, self.mesh)


def place(x: torch.Tensor, sharding: "NamedSharding | None"):
    """``x`` (the full tensor, the same on every rank) as a DTensor with
    ``sharding``'s placements; a plain tensor when ``sharding`` is None."""
    if sharding is None:
        return x
    if compat.is_dtensor(x):
        return x.redistribute(sharding.mesh, sharding.placements())
    return compat.distribute_tensor(x, sharding.mesh, sharding.placements())


def place_tree(tree: Any, shardings: Any) -> Any:
    """``place`` over a tree and a matching tree of shardings."""
    return trees.tree_map(place, tree, shardings)


def like(x, ref):
    """``x`` (a DTensor) redistributed to ``ref``'s placements -- a
    gradient reduced to its parameter's layout (the data-parallel
    all-reduce of a partial sum); a plain ``x`` as it is."""
    if not compat.is_dtensor(x):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def shard_count(x, dim: int) -> int:
    """How many shards tensor dim ``dim`` of ``x`` is split into (1 for a
    plain tensor)."""
    if not compat.is_dtensor(x):
        return 1
    dim %= x.dim()
    n = 1
    for i, p in enumerate(x.placements):
        if isinstance(p, compat.Shard) and p.dim == dim:
            n *= x.device_mesh.size(i)
    return n


def unshard_dim(x, dim: int):
    """``x`` with tensor dim ``dim`` gathered on every rank (other dims
    keep their placements): the input of an op DTensor cannot run on a
    sharded dim.  A plain tensor is returned as it is."""
    if not compat.is_dtensor(x):
        return x
    dim %= x.dim()
    placements = [compat.Replicate()
                  if isinstance(p, compat.Shard) and p.dim == dim else p
                  for p in x.placements]
    return x.redistribute(x.device_mesh, placements)


def full(x):
    """The whole value of ``x`` on every rank: a DTensor gathered, a plain
    tensor as it is."""
    return x.full_tensor() if compat.is_dtensor(x) else x


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshRules:
    dp: tuple[str, ...]            # data-parallel axes (("pod","data") or ("data",))
    tp: str = "model"
    sp: bool = True                # sequence-parallel residual stream
    kv_mode: str = "heads"         # "heads" | "seq"

    # ---- activation specs -------------------------------------------------
    def act(self, kind: str) -> P:
        tp = self.tp
        seq = tp if self.sp else None
        table = {
            "tokens": P(self.dp, None),                  # [B, T]
            "btd": P(self.dp, seq, None),                # residual stream
            "btf": P(self.dp, None, tp),                 # MLP hidden
            "bthd": P(self.dp, None, tp, None),          # per-head acts
            "btkd": P(self.dp, None, tp, None),          # per-kv-head acts
            "logits": P(self.dp, None, tp),              # vocab-sharded
            "bte": P(self.dp, None, None),               # router probs
            "ecd": P(tp, None, None),                    # expert dispatch buf
            "becd": P(self.dp, tp, None, None),          # grouped dispatch
            "frames": P(self.dp, None, None),            # frontend embeds
        }
        return table[kind]

    def kv_cache(self, stacked: bool = True) -> P:
        # cache leaf: [B, S, KvH, Dh] (+ leading layer-stack dim if stacked)
        # The static preference only; ``cache_leaf_pspec`` is the
        # divisibility-aware one.
        if self.kv_mode == "seq":
            base = (self.dp, self.tp, None, None)
        else:
            base = (self.dp, None, self.tp, None)
        return P(*(((None,) + base) if stacked else base))

    def ssm_cache(self, stacked: bool = True) -> P:
        # conv state [B, d_conv-1, CH]; ssd state [B, H, dh, N] -> shard H/CH.
        base = (self.dp, None, self.tp)
        return P(*(((None,) + base) if stacked else base))


def make_rules(multi_pod: bool = False, sp: bool = True,
               kv_mode: str = "heads") -> MeshRules:
    return MeshRules(dp=("pod", "data") if multi_pod else ("data",),
                     sp=sp, kv_mode=kv_mode)


def cache_leaf_pspec(path, shape, rules: MeshRules, mesh) -> P:
    """Divisibility-aware spec for one KV/SSM cache leaf.  ``path`` is the
    leaf's path (dict keys, list indices: ``tree.leaves_with_path``).

    Preference order per leaf kind; an axis is only assigned when the dim
    divides evenly and the axis is not already used.  A batch=1
    long-context cache falls back to sharding the sequence dim over ALL
    axes (the flash-decoding layout)."""
    names = [p if isinstance(p, str) else "" for p in path]
    leaf = names[-1] if names else ""
    stacked = "blocks" in names
    dp, tp = rules.dp, rules.tp

    def size(axes) -> int:
        return axes_size(mesh, axes)

    base_ndim = len(shape) - (1 if stacked else 0)
    dims = tuple(shape[1:] if stacked else shape)
    all_axes = dp + (tp,)
    if leaf in ("k", "v", "c_kv", "k_rope"):     # [B, S, KvH, Dh] / [B, S, R]
        prefs = ([(0, dp), (1, (tp,))] if rules.kv_mode == "seq"
                 else [(0, dp), (2, (tp,)), (1, (tp,))])
        seq_dim = 1
    elif leaf == "conv":                         # [B, K-1, CH]
        prefs = [(0, dp), (2, (tp,))]
        seq_dim = None
    elif leaf == "ssd":                          # [B, H, P, N]
        prefs = [(0, dp), (1, (tp,)), (2, (tp,))]
        seq_dim = None
    else:
        return P()

    assign: list = [None] * base_ndim
    used: set = set()
    for dim, axes in prefs:
        if dim >= base_ndim or assign[dim] is not None:
            continue
        axes = tuple(axes)
        if any(a in used for a in axes):
            continue
        if dims[dim] % size(axes) == 0 and dims[dim] >= size(axes):
            assign[dim] = axes if len(axes) > 1 else axes[0]
            used.update(axes)
    # batch=1 fallback: spread the sequence over every unused axis.
    if seq_dim is not None and assign[seq_dim] is None:
        free = tuple(a for a in all_axes if a not in used)
        if free and dims[seq_dim] % size(free) == 0:
            assign[seq_dim] = free
            used.update(free)
    if stacked:
        assign = [None] + assign
    return P(*assign)


def cache_shardings(cache, rules: MeshRules, mesh) -> Any:
    """``NamedSharding`` tree for a model cache."""
    return trees.tree_map_with_path(
        lambda path, leaf: NamedSharding(
            mesh, cache_leaf_pspec(path, tuple(leaf.shape), rules, mesh)),
        cache)


@dataclasses.dataclass
class ShardingCtx:
    """Carried through the model; a no-op when ``mesh`` is None."""

    mesh: Any = None
    rules: MeshRules | None = None

    @property
    def active(self) -> bool:
        return self.mesh is not None and self.rules is not None

    def axis_size(self, axes) -> int:
        return axes_size(self.mesh, axes)

    def act(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        """``x`` redistributed to the rule for ``kind``; an axis that does
        not divide its dim is dropped (the reference's guard against a
        replicate-and-pad layout)."""
        if not self.active:
            return x
        spec = tuple(self.rules.act(kind))
        if len(spec) < x.ndim:
            spec = spec + (None,) * (x.ndim - len(spec))
        spec = spec[:x.ndim]
        fixed = tuple(a if x.shape[i] % self.axis_size(a) == 0 else None
                      for i, a in enumerate(spec))
        return self.constrain(x, P(*fixed))

    def constrain(self, x: torch.Tensor, spec) -> torch.Tensor:
        """``x`` (a DTensor, or a plain tensor holding the same value on
        every rank) as a DTensor with ``spec``'s placements."""
        placements = to_placements(spec, self.mesh)
        if not compat.is_dtensor(x):
            x = compat.DTensor.from_local(
                x, self.mesh, [compat.Replicate()] * len(placements),
                run_check=False)
        return x.redistribute(self.mesh, placements)

    def seq_whole(self, x: torch.Tensor) -> torch.Tensor:
        """The SP -> TP transition: a sequence-sharded activation [B, T,
        ...] gathered over T before the projections read it (DTensor
        flattens no sharded T into a matmul's rows); a no-op without a
        mesh or without SP."""
        if not self.active:
            return x
        return unshard_dim(x, 1)

    def region(self):
        """The context a sharded forward runs in: plain tensors made inside
        it (positions, masks, constants) meet DTensors as replicated."""
        if not self.active:
            return contextlib.nullcontext()
        return compat.implicit_replication()

    def tp_size(self) -> int:
        return self.axis_size(self.rules.tp)

    def tp_group(self):
        """The process group of the ``model`` axis (``DeviceMesh``)."""
        return self.mesh.get_group(self.rules.tp)


# ---------------------------------------------------------------------------
# Parameter specs by path-name rules
# ---------------------------------------------------------------------------

# (regex on the '/'-joined param path) -> spec for the UNSTACKED
# parameter; stacked blocks get a leading layer dim, prepended as None.
_PARAM_RULES: list[tuple[str, tuple[Any, ...] | None]] = [
    (r"embed$",              ("model", None)),        # [V, D] vocab-sharded
    (r"unembed$",            (None, "model")),        # [D, V]
    (r"(q_proj|k_proj|v_proj)$", (None, "model")),    # [D, H*dh]
    (r"o_proj$",             ("model", None)),        # [H*dh, D]
    (r"kv_down$",            (None, None)),           # [D, lora+rope] small
    (r"kv_up$",              (None, "model")),        # [lora, H*(nope+v)]
    (r"(gate_proj|up_proj)$", (None, "model")),       # [D, F]
    (r"down_proj$",          ("model", None)),        # [F, D]
    (r"router$",             (None, None)),           # [D, E]
    (r"experts_(gate|up)$",  ("model", None, None)),  # [E, D, Fe] EP
    (r"experts_down$",       ("model", None, None)),  # [E, Fe, D] EP
    (r"shared_(gate|up)_proj$", (None, "model")),
    (r"shared_down_proj$",   ("model", None)),
    (r"(z_proj|x_proj)$",    (None, "model")),        # mamba [D, di]
    (r"(b_proj|c_proj)$",    (None, "model")),        # [D, G*N]
    (r"dt_proj$",            (None, "model")),        # [D, nH]
    (r"conv_w$",             ("model", None)),        # [CH, d_conv]
    (r"conv_b$",             ("model",)),
    (r"(a_log|ssm_d|dt_bias)$", ("model",)),          # per-head [nH]
    (r"(frontend_proj)$",    (None, None)),
    (r".*norm.*",            None),                   # replicated
    (r"(conv1_w|pc_w|cc_w|dec_w\d|conv1_b|pc_b|dec_b\d)$", None),  # capsnet
]


def _spec_for_path(path: str, ndim: int) -> P:
    for pattern, axes in _PARAM_RULES:
        if re.search(pattern, path):
            if axes is None:
                return P()
            axes = tuple(axes)
            if len(axes) < ndim:   # stacked: leading layer dim(s)
                axes = (None,) * (ndim - len(axes)) + axes
            elif len(axes) > ndim:
                axes = axes[-ndim:]
            return P(*axes)
    return P()                     # default: replicate


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def param_pspecs(params: Any) -> Any:
    """Tree of specs matching a parameter tree (tensors or meta tensors)."""
    return trees.tree_map_with_path(
        lambda path, leaf: _spec_for_path(_path_str(path), leaf.dim()),
        params)


def param_shardings(params: Any, mesh) -> Any:
    return trees.tree_map_with_path(
        lambda path, leaf: NamedSharding(
            mesh, _spec_for_path(_path_str(path), leaf.dim())), params)


def _zero1_spec(path, leaf, mesh, dp_axes: tuple[str, ...]) -> P:
    shape = tuple(leaf.shape)
    dp_size = axes_size(mesh, dp_axes)
    spec = _spec_for_path(_path_str(path), len(shape))
    axes = list(spec) + [None] * (len(shape) - len(spec))
    # pick the largest unsharded, divisible dim
    cand = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in cand:
        if axes[i] is None and shape[i] % dp_size == 0 \
                and shape[i] >= dp_size:
            axes[i] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
            break
    return P(*axes)


def zero1_pspecs(params: Any, mesh, dp_axes: tuple[str, ...]) -> Any:
    """ZeRO-1: optimizer-state specs = param spec + dp sharding on the
    largest dim that is still unsharded and divisible by the dp size."""
    return trees.tree_map_with_path(
        lambda path, leaf: _zero1_spec(path, leaf, mesh, dp_axes), params)


def zero1_shardings(params: Any, mesh, dp_axes: tuple[str, ...]) -> Any:
    """``NamedSharding`` tree of ``zero1_pspecs``."""
    return trees.tree_map_with_path(
        lambda path, leaf: NamedSharding(
            mesh, _zero1_spec(path, leaf, mesh, dp_axes)), params)
