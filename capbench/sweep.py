"""The knee of an open-loop serving cell, by one sweep on the card.

    python3 capbench/sweep.py --workload mnist-server \\
        --rates 8000,10000,12000 --seconds 10 --seed 7

For each rate, the cell's set-up and one window at that rate in place of
the cell's own: p50, p99 and the largest latency, and whether the
backlog grew (the median latency of the window's last tenth of arrivals
against its first tenth).  The knee is the highest rate whose p99 meets
``--limit-ms`` with no growing backlog; the cell runs at a fixed
fraction of it, written into its file as a number.
"""

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--limit-ms", type=float, default=15.0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from capbench import harness, spec, trace
    from capbench.drivers import serve

    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    base = spec.cell(args.workload)
    knee = None
    for k, rate in enumerate(float(r) for r in args.rates.split(",")):
        cell = spec.Cell(**{**base.__dict__,
                            "params": dict(base.params, rate_per_s=rate)})
        seed = args.seed + k
        cfg = cell.config
        family = spec.family_of(cfg)
        ctx = harness.Ctx(cfg=cfg, pcfg=family.program_config(cfg),
                          mix=cell.mix, params=cell.params,
                          limits=cell.limits, device=dev, seed=seed,
                          weights=family.weights(cfg, seed, dev),
                          pool=family.pool(cfg, cell.params, seed, dev))
        drv = serve.Driver(ctx)
        gc.collect()
        gc.freeze()                      # as run_cell does after set-up
        t0 = time.perf_counter()
        rec = drv.window(args.seconds, trace.no_span)
        wall = time.perf_counter() - t0
        reqs = sorted(drv.window_reqs, key=lambda r: r.due_s)
        lat = np.array([r.finished_s - r.due_s for r in reqs]) * 1e3
        tenth = max(1, len(lat) // 10)
        first, last = np.median(lat[:tenth]), np.median(lat[-tenth:])
        grows = bool(last > 2.0 * first and last > 2.0)
        ok = rec["latency_p99_ms"] <= args.limit_ms and not grows
        if ok:
            knee = rate
        print(json.dumps(dict(
            rate_per_s=rate, seed=seed, p50_ms=rec["latency_p50_ms"],
            p99_ms=rec["latency_p99_ms"], max_ms=float(lat.max()),
            first_tenth_ms=float(first), last_tenth_ms=float(last),
            backlog_grows=grows, meets=ok, occupancy=rec["occupancy"],
            served_per_s=rec["images"] / rec["wall_s"], wall_s=wall,
            late_p99_ms=rec["late_p99_ms"])), flush=True)
        gc.unfreeze()
        del drv, ctx, w, x, y
        gc.collect()
        torch.cuda.empty_cache()
    print(f"knee: {knee} (p99 <= {args.limit_ms} ms, no growing backlog)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
