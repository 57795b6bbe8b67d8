"""What the program's spans cost a serving tick, off and on.

    python3 chipjobs/span_cost.py --workload mnist-offline --seed <n> \\
        [--ticks 300] [--rounds 3] [--out cost.json]

One engine, set up as ``capbench/run.py`` sets it up, ticks under a
backlog (the queue topped up to twice the slots before each ``step()``)
in arms that take turns, ``--rounds`` times: ``off`` (no profiler, the
spans as shipped: one flag check each), ``bare`` (no profiler, every
span and sample replaced by a constant no-op: no check at all), ``on``
(under ``torch.profiler`` with CPU and CUDA activity, the spans as
shipped), ``on_bare`` (under the profiler, spans and samples replaced:
a traced tick without them), ``on_nosample`` (under the profiler, spans on,
samples off) and ``on_fast`` (under the profiler, each span entered
through ``torch._C._profiler._RecordFunctionFast`` in place of
``record_function``).  Prints each arm's ``step()`` p50 and mean (ms).
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from idle_by_span import cell_driver  # noqa: E402

ARMS = ("off", "bare", "on", "on_bare", "on_nosample", "on_fast")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    from repro_torch import obs
    cell, driver = cell_driver(args.workload, args.seed)
    eng = driver.engine
    target = 2 * driver.slots
    real = dict(span=obs.span, sample=obs.sample, recording=obs.recording)
    bare = dict(span=lambda name, part="": obs._OFF,
                sample=lambda name, value: None, recording=lambda: False)
    rf = torch.profiler.record_function
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)

    def ticks(n):
        out = []
        for _ in range(n):
            driver._fill(target - len(eng.queue))
            t = time.perf_counter()
            eng.step()
            out.append(time.perf_counter() - t)
        torch.cuda.synchronize()
        return out

    def arm(name):
        fns = bare if name in ("bare", "on_bare") else real
        for k, v in fns.items():
            setattr(obs, k, v)
        if name == "on_nosample":
            obs.sample, obs.recording = bare["sample"], bare["recording"]
        if name == "on_fast":
            if fast is None:
                return None
            torch.profiler.record_function = fast
        try:
            if name.startswith("on"):
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]):
                    got = ticks(args.ticks)
            else:
                got = ticks(args.ticks)
        finally:
            torch.profiler.record_function = rf
            for k, v in real.items():
                setattr(obs, k, v)
            obs.reset()
        return got

    import gc
    gc.collect()
    gc.freeze()
    ticks(20)
    times = {a: [] for a in ARMS}
    rounds = []
    for r in range(args.rounds):
        row = {}
        for a in ARMS:
            got = arm(a)
            if got is None:
                continue
            times[a] += got
            row[a] = 1e3 * statistics.median(got)
        rounds.append(row)
        print(f"round {r}: " + ", ".join(f"{a} {v:.4f}" for a, v in
                                         row.items()), flush=True)
    res = {a: dict(p50_ms=1e3 * statistics.median(v),
                   mean_ms=1e3 * statistics.fmean(v), n=len(v))
           for a, v in times.items() if v}
    out = dict(workload=args.workload, seed=args.seed, ticks=args.ticks,
               card=torch.cuda.get_device_name(0), arms=res, rounds=rounds,
               torch=torch.__version__)
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
