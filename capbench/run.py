"""Run one cell of the benchmark once, on the machine it is started on.

    python3 capbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (weights and images from the seed, the program's plan and
engine or training step, a warm-up of the cell's own shapes), then the
measured window, then the correctness check against the plain
reference.  The last line of standard output is one JSON object: the
cell's end-to-end metrics (``--trace 0``) or its per-layer metrics
(``--trace 1``, read from a profiled window that is whole), whether the
outputs are correct, the requests or steps attempted and failed, and
the device.  The numbers compared, each with its limit, are the last
lines on standard error and the last key of that object.

Exits non-zero, printing no result, without a CUDA device (or with
fewer than the cell asks for), and where JAX or the JAX package has
been loaded by the time the window closes.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list[str]:
    """The modules of ``names`` (default: every loaded module) whose
    top-level name is JAX's or the JAX package's, compared whole."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def fail(msg: str) -> int:
    print(f"capbench: {msg}", file=sys.stderr, flush=True)
    return 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    marks = [("start", T0), ("arguments", time.perf_counter())]

    import torch
    marks.append(("import torch", time.perf_counter()))

    from capbench import harness, spec

    try:
        cell = spec.cell(args.workload)
        chips = next(w["chips"] for w in spec.benchmark()["workloads"]
                     if w["name"] == args.workload)
    except (OSError, KeyError, ValueError) as err:
        return fail(f"cannot read the cell: {err}")
    if not torch.cuda.is_available():
        return fail("no CUDA device is available; the benchmark measures "
                    "the card and never falls back to the CPU")
    if torch.cuda.device_count() < chips:
        return fail(f"the cell asks for {chips} CUDA devices, "
                    f"{torch.cuda.device_count()} are available")
    marks.append(("the cell and the look for the card", time.perf_counter()))
    try:
        import repro_torch  # noqa: F401
    except ImportError as err:
        return fail(f"the program (repro_torch) is not importable: {err}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.cuda.init()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    marks.append(("the device", time.perf_counter()))
    harness.log("before the cell: " + ", ".join(
        f"{n} {b - a:.3f}" for (_, a), (n, b) in zip(marks, marks[1:])))
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           device=dev, t0=T0)
    found = forbidden_modules()
    if found:
        return fail(f"loaded in this process once the window closed: "
                    f"{found}")
    harness.log(f"card: {card()}")
    checks = out["checks"]
    for name, c in checks.items():
        where = (f" (worst {c['worst']!r}" if "worst" in c else "") + (
            f", leaf {c['leaf']}" if "leaf" in c else "") + (
            ")" if "worst" in c else "")
        harness.log(f"check {name}: {c['value']!r} limit {c['limit']!r}"
                    f"{where}")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    if args.trace:
        device.update(busy_s=out["busy_s"], window_s=out["window_s"])
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": device}
    if args.trace:
        result["breakdown"] = out["breakdown"]
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
