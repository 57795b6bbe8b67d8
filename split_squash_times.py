#!/usr/bin/env python3
"""K14a (caps_votes) and K10 (squash, forward and backward) at
``chip_smoke.py``'s phase-11 sites, for one checkout on one NVIDIA GPU.

    python3 split_squash_times.py [CHECKOUT]

It imports the ``repro_torch`` package of CHECKOUT (default: the checkout
this script lies in) and the timing helpers of the ``chip_smoke.py``
beside this script.  On seeded inputs made with numpy it prints one line
a site, at CHECKOUT's own schedule (its planner's ``block_i`` and
``block_rows``): the kernel's device ms with the L2 warm and cold (after
128 MB written, the L2 full of dirty lines) and clean cold (after 128 MB
read), the byte bound and each time's share of it, the grid and the
device ms of an empty launch of that grid (the floor under the kernel),
and the SHA-256 of the output (the same digest in two checkouts means the same bits).
K14a also gets ``torch.einsum``'s device ms on the same inputs.  Then one
line for the split path (K14a -> K14b at MNIST width, batch 8), its
device ms by kernel.  Run it for two checkouts in one call, in turns
(parent, change, change, parent), to compare them.  It imports nothing
of JAX, and exits non-zero without a CUDA device.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

SEED = 0
MNIST = dict(i=1152, c=8, n=160)        # ClassCaps-FC: 1152 -> 10 x 16D
THREADS = 256                           # a CTA of the earlier kernels


def digest(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("split_squash_times: no CUDA device is available",
              file=sys.stderr)
        return 2
    root = Path(sys.argv[1] if len(sys.argv) > 1
                else Path(__file__).resolve().parent).resolve()
    sys.path.insert(0, str(root / "src"))
    import chip_smoke as cs
    from repro_torch.core import execplan
    from repro_torch.kernels import caps_votes as k14a
    from repro_torch.kernels import ops
    from repro_torch.kernels import squash as k10

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"split_squash_times: repro_torch from {root}, on {card}",
          flush=True)

    def randn(*shape, scale=1.0):
        return torch.tensor(scale * rng.standard_normal(shape, np.float32),
                            device=dev)

    # The schedule CHECKOUT's planner gives, and its grid; a checkout from
    # before the kernels' redesign has other signatures and 256-thread
    # CTAs.
    def votes_plan(i, c, n, b):
        bi = ops.planned_block_i(i, c, n, b)
        grid = (execplan.caps_votes_grid(i, n, bi)
                if hasattr(execplan, "caps_votes_grid")
                else (-(-i // bi), THREADS))
        return bi, grid

    def squash_plan(r, d):
        try:
            br = execplan.squash_block_rows(d, r)
        except TypeError:
            br = execplan.squash_block_rows(d)
        grid = (execplan.squash_grid(r, br, execplan.squash_lanes(d))
                if hasattr(execplan, "squash_grid")
                else (-(-r // br), THREADS))
        return br, grid

    def site(kernel, label, fn, nbytes, grid, library=None):
        out = fn()
        warm = cs.device_ms(fn)
        cold = cs.cold_device_ms(fn, kernel)
        clean = cs.cold_device_ms(fn, kernel, clean=True)
        empty = cs.grid_floor(*grid)["device_ms"]
        bms = nbytes / cs.PEAK_HBM_BYTES * 1e3
        row = dict(site=f"{kernel} {label}", device_ms=warm,
                   cold_device_ms=cold, clean_cold_device_ms=clean,
                   bound_ms=bms,
                   warm_share=bms / warm if warm else None,
                   cold_share=bms / cold if cold else None,
                   grid=list(grid), empty_launch_device_ms=empty,
                   over_empty=warm / empty if warm and empty else None,
                   sha256=digest(out))
        if library is not None:
            row["library_device_ms"] = cs.device_ms(library)
        print(json.dumps(row), flush=True)

    with torch.no_grad():
        # K14a at MNIST width: the engine's batch 8, and batches 1 and 64.
        for b in (8, 1, 64):
            u = randn(b, MNIST["i"], MNIST["c"], scale=0.5)
            w = randn(MNIST["i"], MNIST["n"], MNIST["c"], scale=0.1)
            bi, grid = votes_plan(MNIST["i"], MNIST["c"], MNIST["n"], b)
            n_out = b * MNIST["i"] * MNIST["n"]
            site("caps_votes", f"MNIST ClassCaps-FC, batch {b}, "
                 f"block_i {bi}",
                 lambda u=u, w=w, bi=bi: k14a.caps_votes(u, w, block_i=bi),
                 4.0 * (u.numel() + w.numel() + n_out), grid,
                 lambda u=u, w=w: torch.einsum("bic,inc->bin", u, w))
        # K10 at the PrimaryCaps capsules (batch 8) and at [4096, 256].
        for r, d in ((8 * MNIST["i"], MNIST["c"]), (4096, 256)):
            x, g = randn(r, d), randn(r, d)
            br, grid = squash_plan(r, d)
            site("squash", f"forward [{r}, {d}], block_rows {br}",
                 lambda x=x, br=br: k10.squash_rows(x, block_rows=br),
                 4.0 * 2 * x.numel(), grid)
            site("squash", f"backward [{r}, {d}], block_rows {br}",
                 lambda x=x, g=g, br=br: k10.squash_bwd(x, g,
                                                        block_rows=br),
                 4.0 * 3 * x.numel(), grid)
        # The split path at MNIST width, batch 8, by kernel.
        u = randn(8, MNIST["i"], MNIST["c"], scale=0.5)
        w = randn(MNIST["i"], MNIST["n"], MNIST["c"], scale=0.1)

        def split():
            return ops.routing(ops.caps_votes(u, w), iters=3,
                               num_classes=10)
        by_kernel = cs.device_breakdown(split, reps=20) or {}
        print(json.dumps(dict(path="split path (caps_votes -> routing), "
                                   "MNIST, batch 8",
                              device_ms=by_kernel.get("total"),
                              sha256=digest(split()), by_kernel=by_kernel)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
