"""Serve CapsuleNet classifications through the port's plan-driven engine.

Compiles ONE ExecutionPlan for the configured CapsNet, prints its
per-operation schedule (kernels, tiles, shared memory a CTA, PMU phases),
derives the PMU gating schedule from the same plan, then streams
MNIST-like requests through the slot-based ``CapsuleEngine`` and reports
per-request latency and throughput.

    PYTHONPATH=src python examples/serve_capsnet_torch.py [--backend torch]

``--backend kernels`` (the default) serves on the port's hand-written
kernels, ``torch`` on the plain PyTorch forward.  ``--use-async`` drives
the same engine through ``AsyncCapsuleServer``: requests are submitted
concurrently from asyncio tasks and each awaits its own terminal status
while the driver recycles slots continuously.  ``--shards N`` lays the
slot batch over N shards (the first N CUDA devices; on ``--device cpu``
every shard is the CPU): ONE ``compile_plan`` gives the per-shard plan,
``slots = shards * plan.batch``.  It runs on the card; ``--device cpu``
runs the plain twins of the kernels.
"""

import argparse
import asyncio
import sys

sys.path.insert(0, "src")

import torch  # noqa: E402

from repro_torch.core import capsnet  # noqa: E402
from repro_torch.core.energy import SRAMConfig  # noqa: E402
from repro_torch.core.execplan import compile_plan  # noqa: E402
from repro_torch.core.pmu import schedule_from_plan  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.serve.capsule import (AsyncCapsuleServer,  # noqa: E402
                                       CapsRequest, CapsuleEngine)
from repro_torch.train.data import DataConfig, mnist_batch  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", choices=capsnet.BACKENDS,
                    default="kernels")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--shards", type=int, default=None,
                    help="shard the slot batch over N devices")
    ap.add_argument("--use-async", action="store_true",
                    help="submit through the asyncio host loop")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, the kernels' plain twins")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = capsnet.CapsNetConfig(image_hw=14, conv1_channels=16,
                                conv1_kernel=5, pc_kernel=3,
                                num_primary_groups=4, primary_dim=4,
                                class_dim=8, use_decoder=False)
    params = capsnet.init_params(torch.Generator().manual_seed(0), cfg,
                                 device=dev)
    # pipeline=True: PrimaryCaps -> ClassCaps served as ONE kernel (K5)
    # when the pair fits a CTA's shared memory (per-op plan otherwise).
    # The plan is compiled for the PER-SHARD batch: slots = shards *
    # plan.batch.
    plan = compile_plan(cfg, batch=args.slots // (args.shards or 1),
                        pipeline=True)

    print("== ExecutionPlan (one schedule: kernels + PMU + serving) ==")
    print(f"{'op':20s} {'kernel':18s} {'block':>18s} {'smem KiB':>9s} "
          f"{'phase KiB':>10s}")
    phases = {r.name: r.required_bytes for r in plan.phase_requirements()}
    for r in plan.summary():
        print(f"{r['name']:20s} {r['kernel']:18s} {str(r['block']):>18s} "
              f"{r['smem_kib']:9.1f} {phases[r['name']] / 1024:10.1f}")

    mem = SRAMConfig("shared", 1 << 20, power_gated=True, sectors_per_bank=64)
    sched = schedule_from_plan(mem, plan)
    print("\n== PMU gating schedule derived from the SAME plan ==")
    for ph in sched.phases:
        print(f"{ph.name:20s} on={ph.on_fraction:5.1%} "
              f"woken={ph.sectors_woken:3d} leak={ph.leakage_mj:.4f} mJ")

    engine = CapsuleEngine(
        params, cfg, slots=args.slots, backend=args.backend,
        plan=plan if args.backend == "kernels" else None, device=dev,
        n_shards=args.shards)
    batch = mnist_batch(DataConfig(global_batch=args.requests), 0,
                        image_hw=cfg.image_hw)
    images = batch["images"]
    if args.use_async:
        async def serve_async():
            async with AsyncCapsuleServer(engine) as server:
                return await asyncio.gather(
                    *(server.submit(images[i % images.shape[0]])
                      for i in range(args.requests)))

        done = asyncio.run(serve_async())
    else:
        for i in range(args.requests):
            engine.submit(CapsRequest(rid=i,
                                      image=images[i % images.shape[0]]))
        done = engine.run()
    s = engine.stats()

    mesh_note = (f", {engine.n_shards} shards x {engine.slots_per_shard} "
                 f"slots/shard" if args.shards else "")
    print(f"\n== served {s['requests']} requests ({args.backend} backend on "
          f"{dev}, {args.slots} slots{mesh_note}"
          f"{', async' if args.use_async else ''}) ==")
    for r in done[:8]:
        print(f"req {r.rid:3d}: {r.status} pred={r.pred} "
              f"latency={1e3 * r.latency_s:7.2f} ms "
              f"queued {r.queue_ticks} ticks")
    print(f"throughput {s['requests_per_s']:8.1f} req/s   "
          f"occupancy {s['occupancy']:.2f}   "
          f"mean latency {s['mean_latency_ms']:.2f} ms")


if __name__ == "__main__":
    main()
