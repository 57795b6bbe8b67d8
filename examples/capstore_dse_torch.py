"""CapStore design-space exploration on the port's plan (paper Secs. 4-5):

  * evaluates all six on-chip organizations (Table 2 / Fig. 10),
  * sweeps sector counts for the power-gated variants,
  * prints the complete-accelerator breakdown (Fig. 11),
  * prints the port's planner -- the same energy-objective DSE, over the
    Hopper GEMM's tiles -- on the plan's own GEMM workloads.

The models score the paper's 32 nm accelerator: they need no card, and
run on the CPU.

    PYTHONPATH=src python examples/capstore_dse_torch.py
"""

import sys

sys.path.insert(0, "src")

from repro_torch.core import dse  # noqa: E402
from repro_torch.core.capsnet import CapsNetConfig  # noqa: E402
from repro_torch.core.execplan import compile_plan, plan_table  # noqa: E402
from repro_torch.core.planner import BlockPlan, MatmulWorkload  # noqa: E402

BATCH = 8                 # the serving engine's slots


def gemm_workloads(cfg: CapsNetConfig, batch: int) -> dict:
    """The plan's GEMMs by op name: Conv1 and PrimaryCaps as im2col
    products (K2), and a conv backward's dpatches product."""
    c1 = MatmulWorkload(m=batch * cfg.conv1_out ** 2,
                        k=cfg.conv1_kernel ** 2 * cfg.in_channels,
                        n=cfg.conv1_channels)
    pc = MatmulWorkload(m=batch * cfg.pc_out ** 2,
                        k=cfg.pc_kernel ** 2 * cfg.conv1_channels,
                        n=cfg.pc_channels)
    return {"Conv1": c1, "PrimaryCaps": pc,
            "PrimaryCaps-bwd": MatmulWorkload(m=pc.m, k=pc.n, n=pc.k)}


def main() -> None:
    # ONE ExecutionPlan: the schedule below is what the port's kernels run.
    cfg = CapsNetConfig()
    plan = compile_plan(cfg)
    profiles = list(plan.profiles)
    orgs = dse.design_organizations(profiles)

    print("== ASIC organizations (paper Table 2) ==")
    print(f"{'org':8s} {'bytes':>8s} {'area mm2':>9s} {'dyn mJ':>8s} "
          f"{'stat mJ':>8s} {'total mJ':>9s}")
    for name in ("SMP", "PG-SMP", "SEP", "PG-SEP", "HY", "PG-HY"):
        ev = dse.evaluate(orgs[name], profiles)
        print(f"{name:8s} {ev.org.total_bytes:8.0f} {ev.area_mm2:9.3f} "
              f"{ev.dynamic_mj:8.4f} {ev.static_mj:8.4f} {ev.total_mj:9.4f}")

    print("\n== sector sweep (power-gated orgs) ==")
    for r in dse.explore(profiles)[:6]:
        print(f"{r.org_name:8s} S={r.sectors:4d} {r.total_mj:8.4f} mJ")

    best = dse.best_design(profiles)
    a = dse.all_onchip_system(profiles)
    c = dse.hierarchy_system(profiles, best.evaluation)
    print(f"\n== complete accelerator with {best.org_name} (Fig. 11) ==")
    print(f"accelerator {c.accelerator_mj:7.3f} mJ")
    print(f"buffers     {c.buffers_mj:7.3f} mJ")
    print(f"on-chip mem {c.onchip_mj:7.3f} mJ")
    print(f"off-chip    {c.offchip_mj:7.3f} mJ")
    print(f"total       {c.total_mj:7.3f} mJ "
          f"(-{1 - c.total_mj/a.total_mj:.0%} vs all-on-chip [11])")

    print(f"\n== the port's plans at batch {BATCH}, gated over their "
          f"executed phases ==")
    plans = [("pipelined", compile_plan(cfg, batch=BATCH, pipeline=True)),
             ("pipelined, train", compile_plan(cfg, batch=BATCH,
                                               pipeline=True, train=True))]
    for row in plan_table(plans):
        print(f"{row['plan']:17s} {row['name']:22s} {row['kernel']:18s} "
              f"{row['mode'] or '-':9s} smem {row['smem_kib']:6.1f} KiB")
    for label, p in plans:
        r = dse.best_design(plan=p)
        print(f"{label:17s} {len(p.phase_groups()):2d} phases: best "
              f"{r.org_name} S={r.sectors} {r.total_mj:.4f} mJ")

    print(f"\n== Hopper planner: the same DSE over the GEMM's tiles, the "
          f"per-op training plan at batch {BATCH} ==")
    train = compile_plan(cfg, batch=BATCH, train=True)
    work = gemm_workloads(cfg, BATCH)
    for op in train.ops:
        block = op.dx_block if op.dx_block and op.name in work else op.block
        if not isinstance(block, BlockPlan) or op.name not in work:
            continue
        w = work[op.name]
        what = "dpatches" if op.name.endswith("-bwd") else op.kernel
        print(f"{op.name:16s} {what:18s} [{w.m}x{w.k}] x [{w.k}x{w.n}]: "
              f"block {block.block_m}x{block.block_k}x{block.block_n} "
              f"split_k {block.split_k:3d} {block.ctas:4d} CTAs  smem "
              f"{block.smem_bytes / 1024:5.1f} KiB  modeled traffic "
              f"{block.hbm_bytes / 2**20:7.2f} MiB  "
              f"AI {w.flops / block.hbm_bytes:5.1f} flops/B")


if __name__ == "__main__":
    main()
