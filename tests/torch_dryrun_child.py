"""The dry run's checks in a process of their own (``python
tests/torch_dryrun_child.py OUT_DIR``): each starts and destroys a fake
process group, which must never live in the pytest process
(``launch.mesh`` builds a real mesh while one does).  Prints one JSON
object as its last line.  No JAX.  Not a test module itself (no
``test_`` prefix)."""

import json
import sys

import torch
import torch.distributed as dist
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.launch import dryrun
from repro_torch.launch.hlo_analysis import analyze_ops
from repro_torch.parallel import compat

DATA = 8                       # ranks of the data-parallel mesh


def cells(out_dir) -> dict:
    """granite-3-2b's train, prefill and decode cells on the production
    mesh, and two cells the skip policy refuses."""
    out = {}
    for arch, shape in (("granite-3-2b", "train_4k"),
                        ("granite-3-2b", "prefill_32k"),
                        ("granite-3-2b", "decode_32k"),
                        ("granite-3-2b", "long_500k"),
                        ("hubert-xlarge", "decode_32k")):
        r = dryrun.run_cell(arch, shape, False, out_dir)
        r["group_left"] = dist.is_initialized()
        out[f"{arch} {shape}"] = r
    return out


def local_flops() -> dict:
    """A [4096, 1024] @ [1024, 8192] matmul, the left operand Shard(0) and
    the right Replicate over a DATA-way data mesh: the counters see each
    rank's local op; FlopCounterMode sees the global one."""
    with dryrun.fake_group(DATA):
        mesh = compat.make_mesh("cuda", (DATA,), ("data",))
        a = compat.distribute_tensor(
            torch.empty(4096, 1024, device="meta"), mesh, [compat.Shard(0)])
        b = compat.distribute_tensor(
            torch.empty(1024, 8192, device="meta"), mesh,
            [compat.Replicate()])
        _, got = analyze_ops(lambda: a @ b)
        with FlopCounterMode(display=False) as fc:
            a @ b
        # Collectives: DTensor's redistributions, a pending Partial in
        # the result, and the explicit compat calls; against
        # CommDebugMode's counts of the same calls.
        x = compat.distribute_tensor(torch.empty(64, 256, device="meta"),
                                     mesh, [compat.Shard(0)])
        flat = torch.empty(64, 256, device="meta")

        def comms():
            x.redistribute(mesh, [compat.Replicate()])
            x.redistribute(mesh, [compat.Shard(1)])
            compat.all_gather_single(
                torch.empty(DATA * 64, 256, device="meta"), flat)
            compat.reduce_scatter_single(
                torch.empty(64 // DATA, 256, device="meta"), flat)
            return x.sum()                    # Partial: reduced in the call

        with CommDebugMode() as comm:
            _, coll = analyze_ops(comms)
        return dict(flops=got.flops, global_flops=fc.get_total_flops(),
                    devices=got.devices,
                    counts=coll.collective_counts,
                    bytes=coll.collective_bytes_by_type,
                    comm_counts={str(k): v for k, v in
                                 comm.get_comm_counts().items()},
                    group_left_inside=dist.is_initialized())


def main() -> int:
    out_dir = sys.argv[1]
    out = {"cells": cells(out_dir), "local": local_flops(),
           "cli_rc": dryrun.main(["--arch", "hubert-xlarge", "--shape",
                                  "decode_32k", "--out", out_dir]),
           "group_left": dist.is_initialized()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
