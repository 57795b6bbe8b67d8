#!/usr/bin/env python3
"""K13 and K13b, the unfused routing oracle (forward and backward), beside
the fused K4 and K9 at ``chip_smoke.py``'s sites, for one checkout on one
NVIDIA GPU.

    python3 oracle_times.py [CHECKOUT]

It imports the ``repro_torch`` package of CHECKOUT (default: the checkout
this script lies in) and the timing helpers of the ``chip_smoke.py``
beside this script.  On seeded inputs made with numpy it prints one line
a site -- the MNIST ClassCaps (1152 capsules of 8D -> 10 x 16D) and the
SVHN bottleneck (2048 of 8D -> 64 x 8D), the forward at batch 8 and the
backward at batch 16, 3 routing iterations -- with the oracle as
CHECKOUT schedules it (``mode="streamed-2pass"``, no cluster named) and
the fused kernel at its planner's cluster for the same i-tile
(``mode="streamed"``): each one's device ms (``torch.profiler``) and
device ms by kernel, the byte or operation bound, and the SHA-256 of each
output (equal digests mean equal bits).  Run it for two checkouts in one
call, in turns (parent, change, change, parent), to compare them.  It
imports nothing of JAX, and exits non-zero without a CUDA device.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

SEED = 0
ORACLE = "streamed-2pass"
# (label, batch, I, C, J, D, block_i, backward)
SITES = (("MNIST ClassCaps", 8, 1152, 8, 10, 16, 128, False),
         ("SVHN bottleneck", 8, 2048, 8, 64, 8, 64, False),
         ("MNIST ClassCaps", 16, 1152, 8, 10, 16, 128, True),
         ("SVHN bottleneck", 16, 2048, 8, 64, 8, 64, True))


def digest(out) -> str:
    h = hashlib.sha256()
    for t in (out if isinstance(out, tuple) else (out,)):
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("oracle_times: no CUDA device is available", file=sys.stderr)
        return 2
    root = Path(sys.argv[1] if len(sys.argv) > 1
                else Path(__file__).resolve().parent).resolve()
    sys.path.insert(0, str(root / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import votes_routing as k34

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"oracle_times: repro_torch from {root}, on {card}", flush=True)

    def randn(*shape, scale=1.0):
        return torch.tensor(scale * rng.standard_normal(shape, np.float32),
                            device=dev)

    for label, b, i, c, j, d, bi, backward in SITES:
        u = randn(b, i, c, scale=0.5)
        w = randn(i, j * d, c, scale=0.1)
        g = randn(b, j * d, scale=1e-2)
        kw = dict(iters=3, num_classes=j, block_i=bi)
        if backward:
            _, fcs = k34.bwd_schedule(u, w, mode="streamed", cluster=None,
                                      iters=3, num_classes=j)

            def oracle():
                return k34.votes_routing_bwd(u, w, g, mode=ORACLE, **kw)

            def fused():
                return k34.votes_routing_bwd(u, w, g, mode="streamed",
                                             cluster=fcs, **kw)
            nbytes = cs.routing_bwd_bytes(u, w)
            flops = cs.routing_bwd_flops(b, i, c, j * d, 3)
        else:
            fcs = k34.fwd_cluster(u, w, mode="streamed", cluster=None, **kw)

            def oracle():
                return k34.votes_routing(u, w, mode=ORACLE, **kw)

            def fused():
                return k34.votes_routing(u, w, mode="streamed", cluster=fcs,
                                         **kw)
            nbytes = 4.0 * (u.numel() + w.numel() + b * j * d)
            flops = cs.routing_flops(b, i, c, j * d, 3)
        bms, by = cs.bound(nbytes, flops)
        with torch.no_grad():
            row = dict(site=f"{'K13b' if backward else 'K13'} {label}, "
                            f"batch {b}, block_i {bi}",
                       bound_ms=bms, bound_by=by)
            for name, fn in (("oracle", oracle), ("fused", fused)):
                parts = cs.device_breakdown(fn, reps=10) or {}
                row[name] = dict(device_ms=parts.pop("total", None),
                                 by_kernel=parts, sha256=digest(fn()))
            row["fused"]["cluster"] = fcs
            row["same_bits"] = row["oracle"]["sha256"] == \
                row["fused"]["sha256"]
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
