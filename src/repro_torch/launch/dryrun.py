"""Production dry run: each (arch x shape x mesh) cell's step run once on
``device="meta"`` under the counters -- the counterpart of
``repro/launch/dryrun.py``.

The reference lowers and compiles each cell on 512 forced host devices.
The port starts a fake process group of the mesh's size (256 ranks for
``pod16x16``, 512 for ``pod2x16x16``; torch's ``"fake"`` backend, whose
collectives return at once), builds the production mesh on it, places
every tensor of the cell on the meta device with the sharding rules, and
runs rank 0's step under ``hlo_analysis.analyze_ops``.  That proves the
distribution config is coherent (every op and redistribution of the
step runs on its local shards) without hardware, and gives per-device
flops, bytes and collective bytes for the H100 roofline (``roofline``)
and each device's memory against 80 GiB.  No device tensor is made:

    python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
    python -m repro_torch.launch.dryrun --arch all --shape all --mesh both

One JSON per cell, under ``results/dryrun_torch/`` by default.

Memory model, per device (``memory_breakdown``): parameters, optimizer
state and caches from their local shards' sizes; in a train cell the
gradients (the parameters' local shards in the gradient type) and, as
activations, the bytes autograd saves for the backward
(``saved_tensors_hooks``; storages counted once, the step's inputs not
counted; a remat block saves its input, and the compute cast copies of
the weights the matmuls save count here); in a prefill or decode cell,
as activations, the largest set of storages the step created that were
alive at once (``OpAnalysis.peak_live_bytes``; a prefill's cache, made
in the step, counted as cache).  ``total`` is their sum: every term held
at once, an upper bound of the train step's peak.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch import tree
from repro_torch.configs.registry import LM_ARCHS, get_config
from repro_torch.launch import roofline as rf
from repro_torch.launch.hlo_analysis import analyze_ops
from repro_torch.launch.mesh import make_production_mesh, mesh_chips
from repro_torch.launch.shapes import SHAPES, cell_supported, input_specs
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models.config import count_params
from repro_torch.parallel import compat
from repro_torch.parallel.sharding import (NamedSharding, P, ShardingCtx,
                                           axes_size, cache_shardings,
                                           make_rules, param_shardings,
                                           place, place_tree, zero1_shardings)
from repro_torch.train.optimizer import OptConfig

HBM_BYTES = 80 * 2**30               # one H100's device memory
MESH_TAGS = {False: "pod16x16", True: "pod2x16x16"}


@contextlib.contextmanager
def fake_group(world: int):
    """A fake process group of ``world`` ranks (this process rank 0),
    destroyed on exit: ``launch.mesh`` builds a ``DeviceMesh`` while it
    lives, so it must not outlive the cell."""
    dist.init_process_group("fake", store=compat.fake_store(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_bytes(t) -> int:
    if not isinstance(t, torch.Tensor):
        return 0
    x = t.to_local() if compat.is_dtensor(t) else t
    return x.numel() * x.element_size()


def _tree_bytes(trees) -> int:
    return sum(_local_bytes(x) for x in tree.leaves(trees))


def _storage_key(t) -> int:
    x = t.to_local() if compat.is_dtensor(t) else t
    return x.untyped_storage()._cdata


@contextlib.contextmanager
def saved_bytes(inputs):
    """Sum into ``out["bytes"]`` the storages autograd saves for the
    backward inside the block, each once, skipping those of ``inputs``."""
    skip = {_storage_key(x) for x in tree.leaves(inputs)
            if isinstance(x, torch.Tensor)}
    seen: dict[int, object] = {}          # keeps each storage alive: its
    out = {"bytes": 0}                    # key is not reused

    def pack(t):
        x = t.to_local() if compat.is_dtensor(t) else t
        s = x.untyped_storage()
        if s._cdata not in skip and s._cdata not in seen:
            seen[s._cdata] = s
            out["bytes"] += s.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        yield out


def _cfg_for(arch: str, remat, bf16_softmax: bool, bf16_norm: bool,
             manual_tp: bool):
    cfg = get_config(arch)
    if remat is not None:
        cfg = dataclasses.replace(cfg, remat=remat)
    if bf16_softmax:
        cfg = dataclasses.replace(cfg, attn_fp32_softmax=False)
    if bf16_norm:
        cfg = dataclasses.replace(cfg, norm_fp32=False)
    if manual_tp:
        cfg = dataclasses.replace(cfg, manual_tp=True)
    return cfg


def build_cell(arch: str, shape_name: str, *, multi_pod: bool,
               sp: bool = True, kv_mode: str | None = None,
               remat: str | None = None, fsdp: bool = False,
               bf16_softmax: bool = False, grad_dtype: str = "fp32",
               bf16_norm: bool = False, manual_tp: bool = False) -> dict:
    """One cell's step and its placed meta arguments (ref ``lower_cell``),
    inside a live process group of the mesh's size."""
    cfg = _cfg_for(arch, remat, bf16_softmax, bf16_norm, manual_tp)
    shape = SHAPES[shape_name]
    if kv_mode is None:
        kv_mode = "seq" if shape.name == "long_500k" else "heads"
    # A CUDA mesh, as on the cards: DTensor then picks NCCL's collectives
    # (an all-to-all where a CPU mesh falls back to an all-gather).  The
    # fake group runs none and every tensor stays on the meta device.
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cuda")
    rules = make_rules(multi_pod=multi_pod, sp=sp, kv_mode=kv_mode)
    shd = ShardingCtx(mesh, rules)
    specs = input_specs(cfg, shape_name)
    dp = rules.dp
    batch_sharding = NamedSharding(mesh, P(dp))
    zero1 = zero1_shardings(specs["params"], mesh, dp)
    if specs["kind"] == "train":
        # FSDP/ZeRO-3-style: params also sharded over dp.
        p_shard = zero1 if fsdp else param_shardings(specs["params"], mesh)
        step = make_train_step(cfg, OptConfig(), shd, grad_dtype=grad_dtype,
                               grad_shardings=p_shard
                               if grad_dtype == "bf16" else None)
        opt = specs["opt_state"]
        args = (place_tree(specs["params"], p_shard),
                {"m": place_tree(opt["m"], zero1),
                 "v": place_tree(opt["v"], zero1), "step": opt["step"]},
                {k: place(v, batch_sharding)
                 for k, v in specs["batch"].items()})
    elif specs["kind"] == "prefill":
        step = make_prefill_step(cfg, shape.seq_len, shd)
        args = (place_tree(specs["params"],
                           param_shardings(specs["params"], mesh)),
                place(specs["tokens"], batch_sharding))
    else:
        step = make_serve_step(cfg, shd)
        b = specs["token"].shape[0]
        tok = (batch_sharding if b % axes_size(mesh, dp) == 0
               else NamedSharding(mesh, P()))
        args = (place_tree(specs["params"],
                           param_shardings(specs["params"], mesh)),
                place_tree(specs["cache"],
                           cache_shardings(specs["cache"], rules, mesh)),
                # A position the step reads on the host: a meta scalar
                # has no value.  The last one: the whole cache attended.
                place(specs["token"], tok), shape.seq_len - 1)
    meta = {"arch": arch, "shape": shape_name, "mesh": MESH_TAGS[multi_pod],
            "chips": mesh_chips(mesh), "sp": sp, "kv_mode": kv_mode,
            "remat": cfg.remat, "fsdp": fsdp, "bf16_softmax": bf16_softmax,
            "grad_dtype": grad_dtype, "bf16_norm": bf16_norm,
            "manual_tp": manual_tp}
    return dict(cfg=cfg, shape=shape, kind=specs["kind"], step=step,
                args=args, meta=meta)


def memory_breakdown(kind: str, args, out, analysis, saved: int,
                     grad_dtype: str = "fp32") -> dict:
    """Each device's bytes (module docstring) and whether they fit."""
    params = _tree_bytes(args[0])
    mem = {"param_bytes": params, "opt_bytes": 0, "grad_bytes": 0,
           "cache_bytes": 0, "activation_bytes": 0}
    live = analysis.peak_live_bytes
    if kind == "train":
        mem["opt_bytes"] = _tree_bytes(args[1])
        per = 2 if grad_dtype == "bf16" else 4
        mem["grad_bytes"] = sum(_local_bytes(p) // p.element_size() * per
                                for p in tree.leaves(args[0]))
        mem["activation_bytes"] = saved
    elif kind == "prefill":
        mem["cache_bytes"] = _tree_bytes(out[1])
        mem["activation_bytes"] = (None if live is None
                                   else max(live - mem["cache_bytes"], 0))
    else:
        mem["cache_bytes"] = _tree_bytes(args[1])
        mem["activation_bytes"] = live
    mem["peak_live_bytes"] = live
    mem["argument_bytes"] = _tree_bytes(args)
    mem["output_bytes"] = _tree_bytes(out)
    mem["total_bytes"] = sum(mem[k] or 0 for k in (
        "param_bytes", "opt_bytes", "grad_bytes", "cache_bytes",
        "activation_bytes"))
    mem["device_bytes"] = HBM_BYTES
    mem["fits"] = mem["total_bytes"] <= HBM_BYTES
    return mem


def analyze_step(kind: str, step, args, grad_dtype: str = "fp32"
                 ) -> tuple:
    """``step(*args)`` once under the counters and autograd's saved-tensor
    hook: ``(its result, its OpAnalysis, its memory_breakdown)``."""
    with saved_bytes(args) as saved:
        out, ops = analyze_ops(step, *args)
    return out, ops, memory_breakdown(kind, args, out, ops, saved["bytes"],
                                      grad_dtype)


def analyze_cell(cell: dict) -> dict:
    """Run the cell's step once under the counters: its roofline, its
    collectives and its memory (ref ``analyze_cell``)."""
    cfg, shape, meta = cell["cfg"], cell["shape"], cell["meta"]
    args = cell["args"]
    t0 = time.time()
    out, ops, memory = analyze_step(cell["kind"], cell["step"], args,
                                    meta["grad_dtype"])
    run_s = time.time() - t0
    n_active = count_params(cfg, active_only=True)
    roof = rf.Roofline(
        flops_per_device=ops.flops,
        hbm_bytes_per_device=rf.hbm_bytes_estimate(ops.memory_bytes,
                                                   memory),
        collective_bytes_per_device=ops.collective_bytes,
        chips=meta["chips"],
        model_flops=rf.model_flops_for(cfg, shape, n_active))
    return {
        **meta,
        "run_s": run_s,
        "params_total": count_params(cfg),
        "params_active": n_active,
        "memory_analysis": memory,
        "collectives": {"counts": ops.collective_counts,
                        "bytes_by_type": ops.collective_bytes_by_type,
                        "total_bytes": ops.collective_bytes},
        "dot_count": ops.dot_count,
        "uncounted": ops.uncounted,
        "devices": sorted({*ops.devices, *(
            (x.to_local() if compat.is_dtensor(x) else x).device.type
            for x in tree.leaves([args, out])
            if isinstance(x, torch.Tensor))}),
        "roofline": roof.to_dict(),
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir,
             **kw) -> dict:
    """One cell: skipped with the reference's reason, ``ok`` with its
    analysis, or ``error`` with its traceback; written to ``out_dir``."""
    mesh_tag = MESH_TAGS[multi_pod]
    ok, why = cell_supported(get_config(arch), SHAPES[shape_name])
    base = {"arch": arch, "shape": shape_name, "mesh": mesh_tag}
    if not ok:
        result = {**base, "status": "skipped", "reason": why}
    else:
        world = 512 if multi_pod else 256
        try:
            with fake_group(world):
                t0 = time.time()
                cell = build_cell(arch, shape_name, multi_pod=multi_pod,
                                  **kw)
                setup_s = time.time() - t0
                result = {"status": "ok", **analyze_cell(cell),
                          "setup_s": setup_s}
                del cell
        except Exception as e:       # a cell's failure is its result
            result = {**base, "status": "error", "error": repr(e),
                      "traceback": traceback.format_exc()[-4000:]}
    if out_dir is not None:
        out_dir = pathlib.Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        fname = f"{arch}_{shape_name}_{mesh_tag}.json".replace("/", "-")
        (out_dir / fname).write_text(json.dumps(result, indent=1))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all", choices=["all", *SHAPES])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--sp", dest="sp", action="store_true", default=True)
    ap.add_argument("--no-sp", dest="sp", action="store_false")
    ap.add_argument("--kv-mode", default=None, choices=[None, "heads", "seq"])
    ap.add_argument("--remat", default=None,
                    choices=[None, "full", "dots", "none"])
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--bf16-softmax", action="store_true")
    ap.add_argument("--grad-dtype", default="fp32",
                    choices=["fp32", "bf16"])
    ap.add_argument("--bf16-norm", action="store_true")
    ap.add_argument("--manual-tp", action="store_true")
    args = ap.parse_args(argv)

    archs = LM_ARCHS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = 0
    for arch in archs:
        for shp in shapes:
            for mp in meshes:
                r = run_cell(arch, shp, mp, args.out, sp=args.sp,
                             kv_mode=args.kv_mode, remat=args.remat,
                             fsdp=args.fsdp,
                             bf16_softmax=args.bf16_softmax,
                             grad_dtype=args.grad_dtype,
                             bf16_norm=args.bf16_norm,
                             manual_tp=args.manual_tp)
                tag = f"{arch:22s} {shp:12s} {'multi' if mp else 'single'}"
                if r["status"] == "ok":
                    roof = r["roofline"]
                    mem = r["memory_analysis"]
                    print(f"[ok]   {tag} bottleneck={roof['bottleneck']:10s}"
                          f" step={roof['step_time_s']*1e3:9.3f}ms"
                          f" mfu={roof['mfu']:.3f}"
                          f" mem={mem['total_bytes'] / 2**30:.2f}GiB"
                          f"{'' if mem['fits'] else ' (does not fit)'}"
                          f" run={r['run_s']:.1f}s", flush=True)
                elif r["status"] == "skipped":
                    print(f"[skip] {tag} ({r['reason']})", flush=True)
                else:
                    failures += 1
                    print(f"[FAIL] {tag}: {r['error']}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
