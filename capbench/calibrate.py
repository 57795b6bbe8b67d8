"""Readings that set a cell's correctness limits, on the card.

    python3 capbench/calibrate.py --workload <name> --seeds 101,102,... \\
        --seconds 2 [--fault NAME] [--out FILE]

For each seed, in one process (the kernels built once): the cell's set-up
and a short window at its own load, the program's compared numbers, and
the control's (the reference in TF32 put in the program's place) on the
same sample.  The limit goes above the largest program reading and below
the smallest control reading.  ``--fault`` plants one of
``capbench/faults.py``'s faults underneath the program for the whole run:
its readings are the fault's.  One JSON line per seed on standard
output, and in ``--out``.  The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    import contextlib

    from capbench import faults, harness, spec

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = spec.cell(args.workload)
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        planted = (faults.FAULTS[args.fault]() if args.fault
                   else contextlib.nullcontext())
        with planted:
            out = harness.run_cell(cell, seed, args.seconds, False,
                                   device=dev, t0=time.perf_counter(),
                                   control=True)
        row = dict(workload=args.workload, seed=seed, fault=args.fault,
                   correct=out["correct"], metrics=out["metrics"],
                   program={k: v["value"] for k, v in out["checks"].items()},
                   leaves={k: v["leaf"] for k, v in out["checks"].items()
                           if "leaf" in v},
                   worst={k: v["worst"] for k, v in out["checks"].items()
                          if "worst" in v},
                   control_worst={k: v["worst"] for k, v
                                  in out["control_checks"].items()
                                  if "worst" in v},
                   control={k: v["value"]
                            for k, v in out["control_checks"].items()})
        print(json.dumps(row), flush=True)
        rows.append(row)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "a") as f:
            for row in rows:
                f.write(json.dumps(row) + "\n")
    for key in rows[0]["program"]:
        prog = [r["program"][key] for r in rows]
        ctrl = [r["control"][key] for r in rows]
        print(f"{args.workload} {key}: program max {max(prog)!r} over "
              f"{len(prog)} seeds; control min {min(ctrl)!r}", flush=True)
    for key in rows[0]["worst"]:
        prog = [r["worst"][key] for r in rows]
        ctrl = [r["control_worst"][key] for r in rows]
        print(f"{args.workload} {key}, worst (reported, not compared): "
              f"program max {max(prog)!r}; control min {min(ctrl)!r}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
