"""Quickstart on the port: the paper end to end in about a minute.

1. Train the CapsuleNet's smoke config (Sabour et al. 2017) on synthetic
   digits: ``capsnet.train_step`` on the port's kernels, forward and
   backward, on the training plan.
2. Profile the full-size MNIST CapsuleNet's inference on the CapsAcc
   16x16 array (paper Fig. 4).
3. Run the CapStore DSE and report the selected memory design (Table 2).

    PYTHONPATH=src python examples/quickstart_torch.py [--steps 60]

It runs on the card; ``--device cpu`` runs the kernels' plain PyTorch
twins instead.  Steps 2 and 3 score the paper's 32 nm accelerator on the
host either way.
"""

import argparse
import sys

sys.path.insert(0, "src")

import torch  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import analysis, capsnet, dse  # noqa: E402
from repro_torch.core.execplan import compile_plan  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.train.data import DataConfig, mnist_batch  # noqa: E402


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--backend", choices=capsnet.BACKENDS,
                    default="kernels")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, the kernels' plain twins")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. train a reduced CapsuleNet on synthetic digits -------------------
    cfg = registry.get_smoke_config("capsnet-mnist")
    params = capsnet.init_params(torch.Generator().manual_seed(0), cfg,
                                 device=dev)
    plan = (compile_plan(cfg, batch=args.batch, pipeline=True, train=True)
            if args.backend == "kernels" else None)
    dc = DataConfig(global_batch=args.batch)
    print(f"== training CapsuleNet ({cfg.num_primary} primary capsules, "
          f"{args.backend} backend on {dev}) ==")
    for step in range(args.steps):
        b = mnist_batch(dc, step, image_hw=cfg.image_hw)
        params, m = capsnet.train_step(params, b["images"], b["labels"], cfg,
                                       lr=args.lr, backend=args.backend,
                                       plan=plan, device=dev)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss {float(m['loss']):.4f} "
                  f"acc {float(m['accuracy']):.2f}")

    # 2. memory analysis of the full-size CapsuleNet (paper Fig. 4) -------
    print("\n== CapsAcc memory analysis (full MNIST CapsuleNet) ==")
    profiles = analysis.capsnet_profiles()
    for p in profiles:
        print(f"{p.name:14s} mem {p.total_mem / 1024:7.1f} KiB  "
              f"cycles {p.total_cycles:9.0f}  offchip "
              f"{(p.offchip_reads + p.offchip_writes) * p.repeats:9.0f}")

    # 3. CapStore DSE (paper Table 2) --------------------------------------
    print("\n== CapStore design space exploration ==")
    results = dse.explore(profiles)
    for r in results[:4]:
        print(f"{r.org_name:7s} S={r.sectors:4d}  {r.total_mj:7.4f} mJ  "
              f"{r.area_mm2:7.2f} mm^2")
    best = results[0]
    print(f"\nselected design: {best.org_name} with {best.sectors} "
          f"sectors/bank (paper selects PG-SEP)")


if __name__ == "__main__":
    main()
