"""Rank bodies of the port's multi-rank CPU tests (``run_ranks`` over gloo).

Each function runs in one spawned process a rank, so this module imports
no JAX: the parent test computes the reference's side and passes numpy
trees in.  Not a test module itself (no ``test_`` prefix).
"""

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import shapes, steps
from repro_torch.models.transformer import lm_loss
from repro_torch.parallel import compat, compress, sharding
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import data, optimizer
from repro_torch.train.loop import LoopConfig, TrainLoop

OPT = dict(warmup_steps=0)
LOOP_OPT = dict(peak_lr=1e-3, warmup_steps=2)


def compress_body(rank, world, seed, n):
    """Each rank's seeded gradient and residual through
    ``compressed_psum`` over the whole group."""
    rng = np.random.default_rng(seed + rank)
    g = torch.from_numpy((rng.standard_normal(n) * 0.01).astype(np.float32))
    r = torch.from_numpy((rng.standard_normal(n) * 1e-4).astype(np.float32))
    out, new_res = compress.compressed_psum(g, None, world, r)
    out0, _ = compress.compressed_psum(g, None, world)
    return dict(g=g.numpy(), r=r.numpy(), out=out.numpy(),
                res=new_res.numpy(), out_nores=out0.numpy())


def compress_world_one(rank, world, g):
    out, _ = compress.compressed_psum(torch.from_numpy(g), None, 1)
    return out.numpy()


def _local_shape(shape, spec, mesh):
    """The local shard's shape a spec implies on this rank (DTensor's
    chunking, ``torch.chunk``'s: dim by dim, mesh dim by mesh dim)."""
    coord = mesh.get_coordinate()
    names = list(mesh.mesh_dim_names)
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in sharding._axes(entry):
            i = names.index(a)
            chunks = torch.arange(out[d]).chunk(mesh.size(i))
            out[d] = len(chunks[coord[i]]) if coord[i] < len(chunks) else 0
    return tuple(out)


def _sharded_step(cfg, np_params, np_batch, mesh, grad_shardings=False):
    shd = sharding.ShardingCtx(mesh, sharding.make_rules(False))
    params = lm_params_from_numpy(np_params, "cpu")
    ps = sharding.place_tree(params, sharding.param_shardings(params, mesh))
    opt = optimizer.init_opt_state(ps)
    gs = sharding.param_shardings(params, mesh) if grad_shardings else None
    step = steps.make_train_step(cfg, optimizer.OptConfig(**OPT), shd,
                                 compute_dtype=torch.float32,
                                 grad_shardings=gs)
    batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    ps, opt, m = step(ps, opt, batch)
    return shd, ps, opt, {k: float(v) for k, v in m.items()}


def _digests(state) -> dict[str, str]:
    """A SHA-256 of each leaf's full value as this rank holds it (a
    collective: every rank gathers); a replicated dim keeps this rank's
    own replica, so digests equal across ranks mean the replicas agree
    bit for bit."""
    return {k: hashlib.sha256(sharding.full(v).detach().numpy().tobytes()
                              ).hexdigest()
            for k, v in tree.leaves_with_keys(state)}


def _sharded_serve(cfg, np_params, np_batch, shd, mesh,
                   cache_dtype=torch.bfloat16) -> dict:
    """The sharded prefill (8 tokens into a 12-slot cache) and one decode
    step: the full logits and the greedy token."""
    params = lm_params_from_numpy(np_params, "cpu")
    placed = sharding.place_tree(params,
                                 sharding.param_shardings(params, mesh))
    toks = torch.from_numpy(np_batch["inputs"][:, :8].astype(np.int64))
    logits, cache = steps.make_prefill_step(
        cfg, 12, shd, cache_dtype=cache_dtype)(placed, toks)
    nxt, dec, _ = steps.make_serve_step(cfg, shd)(
        placed, cache, torch.full((toks.shape[0], 1), 3), 8)
    return dict(prefill=sharding.full(logits).numpy(), decode=dec.numpy(),
                next=nxt.numpy())


def _count_collectives() -> list:
    """Count the explicit collectives of ``rs_proj`` / ``ag_seq``."""
    calls = [0]
    for name in ("reduce_scatter_single", "all_gather_single"):
        fn = getattr(compat, name)

        def counted(*a, _fn=fn, **k):
            calls[0] += 1
            return _fn(*a, **k)

        setattr(compat, name, counted)
    return calls


def step_body(rank, world, cases):
    """On a (2, 2) ("data", "model") mesh: the sharded fp32 step of each
    case; for granite also its loss and step with ``manual_tp`` and the
    local shard shapes; digests of each case's full parameters and Adam
    moments after the step; each case's sharded prefill and decode."""
    mesh = lmesh.make_debug_mesh(2, 2)
    out = {"metrics": {}, "digests": {}, "serve": {}}
    for arch, np_params, np_batch in cases:
        cfg = registry.get_smoke_config(arch)
        shd, ps, opt, m = _sharded_step(cfg, np_params, np_batch, mesh)
        out["metrics"][arch] = m
        out["digests"][arch] = _digests({"params": ps, "m": opt["m"],
                                         "v": opt["v"]})
        out["serve"][arch] = _sharded_serve(cfg, np_params, np_batch, shd,
                                            mesh, torch.float32)
        if arch != "granite-3-2b":
            continue
        batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
        params = lm_params_from_numpy(np_params, "cpu")
        placed = sharding.place_tree(params,
                                     sharding.param_shardings(params, mesh))
        losses = {}
        calls = _count_collectives()
        with torch.no_grad():
            for name, c in (("auto", cfg), ("manual", dataclasses.replace(
                    cfg, manual_tp=True))):
                losses[name] = float(sharding.full(lm_loss(
                    placed, batch, c, shd)[0]))
        out["manual_tp"] = losses
        out["manual_collectives"] = calls[0]
        _, _, _, mm = _sharded_step(
            dataclasses.replace(cfg, manual_tp=True), np_params, np_batch,
            mesh)
        out["manual_step"] = mm
        specs = dict(tree.leaves_with_path(sharding.param_shardings(
            params, mesh)))
        out["local_ok"] = all(
            tuple(leaf.to_local().shape) == _local_shape(
                leaf.shape, specs[path].spec, mesh)
            for path, leaf in tree.leaves_with_path(placed))
        out["n_sharded_leaves"] = sum(
            any(isinstance(p, compat.Shard) for p in leaf.placements)
            for leaf in tree.leaves(placed))
    return out


def restore_body(rank, world, np_params, np_batch, ckpt_dir, loop_dir):
    """granite on a (2, 2) mesh: a step with ``grad_shardings``, a ZeRO-1
    step, the sharded prefill/serve steps, a checkpoint written at (2, 2)
    and restored onto (1, 4), and a sharded ``TrainLoop`` run 3 steps at
    (2, 2) and resumed to 5 at (1, 4)."""
    cfg = registry.get_smoke_config("granite-3-2b")
    mesh = lmesh.make_debug_mesh(2, 2)
    out = {}
    shd, ps, _, out["step"] = _sharded_step(cfg, np_params, np_batch, mesh)
    _, _, _, out["grad_shardings_step"] = _sharded_step(
        cfg, np_params, np_batch, mesh, grad_shardings=True)
    batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    params = lm_params_from_numpy(np_params, "cpu")
    placed = sharding.place_tree(params,
                                 sharding.param_shardings(params, mesh))
    out.update(_sharded_serve(cfg, np_params, np_batch, shd, mesh))
    # ZeRO-1: the moments sharded over data as well.
    zs = sharding.zero1_shardings(params, mesh, ("data",))
    opt = optimizer.init_opt_state(placed)
    opt["m"] = sharding.place_tree(opt["m"], zs)
    opt["v"] = sharding.place_tree(opt["v"], zs)
    zstep = steps.make_train_step(cfg, optimizer.OptConfig(**OPT), shd,
                                  compute_dtype=torch.float32)
    _, opt2, mz = zstep(placed, opt, batch)
    out["zero1_step"] = {k: float(v) for k, v in mz.items()}
    out["zero1_kept"] = all(
        a.placements == b.placements for a, b in zip(
            tree.leaves(opt2["m"]), tree.leaves(opt["m"])))
    out["zero1_sharded"] = sum(
        sharding.shard_count(m, d) > sharding.shard_count(p, d)
        for m, p in zip(tree.leaves(opt2["m"]), tree.leaves(placed))
        for d in range(m.dim()))
    # Write at (2, 2) (rank 0 writes full tensors) ...
    ckpt.save({"params": ps}, ckpt_dir, 1)
    written = {k: sharding.full(v).numpy()      # a collective: all
               for k, v in tree.leaves_with_keys(ps)}   # ranks gather
    out["written"] = written if rank == 0 else None
    # ... restore onto (1, 4).
    mesh14 = lmesh.make_debug_mesh(1, 4)
    shardings14 = sharding.param_shardings(params, mesh14)
    template = {"params": sharding.place_tree(
        lm_params_from_numpy(np_params, "cpu"), shardings14)}
    restored, manifest = ckpt.restore(template, ckpt_dir,
                                      shardings={"params": shardings14})
    out["restored_step"] = manifest["step"]
    out["restored_mesh"] = all(
        tuple(leaf.device_mesh.mesh.shape) == (1, 4)
        for leaf in tree.leaves(restored))
    out["restored"] = {k: sharding.full(v).numpy() for k, v in
                       tree.leaves_with_keys(restored["params"])}
    out["loop"] = (_loop(cfg, (2, 2), loop_dir, 3)
                   + _loop(cfg, (1, 4), loop_dir, 5))
    return out


def _loop(cfg, shape, ckpt_dir, total_steps):
    """A sharded ``TrainLoop`` on a ``shape`` mesh, resuming whatever
    ``ckpt_dir`` holds: its history."""
    mesh = lmesh.make_debug_mesh(*shape)
    shd = sharding.ShardingCtx(mesh, sharding.make_rules(False))
    template = shapes.param_specs(cfg, torch.float32)
    loop = TrainLoop(
        cfg, optimizer.OptConfig(**LOOP_OPT), loop_data(cfg),
        LoopConfig(total_steps=total_steps, ckpt_every=2, ckpt_dir=ckpt_dir,
                   log_every=1000),
        shd=shd, param_shardings=sharding.param_shardings(template, mesh),
        device="cpu")
    return [(r["step"], r["loss"], r["grad_norm"]) for r in loop.run()]


def loop_data(cfg):
    return data.DataConfig(kind="lm", vocab_size=cfg.vocab_size, seq_len=32,
                           global_batch=4)
