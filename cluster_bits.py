#!/usr/bin/env python3
"""Digests of the cluster routing kernels' outputs, to compare two checkouts
bit for bit on one NVIDIA GPU.

    python3 cluster_bits.py [CHECKOUT]

For each site of ``chip_smoke.py`` where K3 (resident votes + routing), K5
(PrimaryCaps -> routing), K8 or K9 (the routing backward) runs, it makes
seeded inputs with numpy, runs the kernel on the schedule that CHECKOUT's
own planner gives (default: the checkout this script lies in), and prints
one line a site: the schedule and the SHA-256 of the output's bytes.  Run
it for two checkouts in one call and compare the lines: where the schedule
is the same, the same digest means the same bits.  It imports the
``repro_torch`` package of CHECKOUT and nothing of JAX, and exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import hashlib
import sys
from pathlib import Path

SEED = 0


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("cluster_bits: no CUDA device is available", file=sys.stderr)
        return 2
    root = Path(sys.argv[1] if len(sys.argv) > 1
                else Path(__file__).resolve().parent).resolve()
    sys.path.insert(0, str(root / "src"))
    from repro_torch.configs import capsnet_mnist, capsnet_svhn
    from repro_torch.core import execplan
    from repro_torch.kernels import primary_routing as k5
    from repro_torch.kernels import votes_routing as k34

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)

    def randn(*shape, scale=1.0):
        return torch.tensor(scale * rng.standard_normal(shape, np.float32),
                            device=dev)

    def uniform(*shape):
        return torch.tensor(rng.random(shape, np.float32), device=dev)

    print(f"cluster_bits: repro_torch from {root}", flush=True)
    for cfg_name, cfg in (("mnist", capsnet_mnist.config()),
                          ("svhn", capsnet_svhn.config())):
        lays = cfg.routing_stack()
        serve = execplan.compile_plan(cfg, batch=8, pipeline=True)
        train = execplan.compile_plan(cfg, batch=16, pipeline=True,
                                      train=True)
        # K5 at the engine's batch, from seeded patches.
        op, lay0 = serve.op(execplan.PIPE_NAME), lays[0]
        kw0 = dict(iters=lay0.iters, num_classes=lay0.num_caps)
        p_pos, k_in = cfg.pc_out ** 2, cfg.pc_kernel ** 2 * cfg.conv1_channels
        args = (uniform(8, p_pos, k_in),
                randn(k_in, cfg.pc_channels, scale=k_in ** -0.5),
                randn(cfg.pc_channels, scale=0.1),
                randn(lay0.in_caps, lay0.jd, lay0.in_dim, scale=0.05))
        sites = [(f"K5 {cfg_name} batch 8", op, lambda op=op, args=args:
                  (k5.primary_routing_patches(
                      *args, mode=op.mode, block_i=op.block_i,
                      cluster=op.cluster, **kw0),))]
        # K3 at every routing op after the first (the first is K5's), K8/K9
        # at every backward op.
        for k, lay in enumerate(lays):
            kw = dict(iters=lay.iters, num_classes=lay.num_caps)
            w = randn(lay.in_caps, lay.jd, lay.in_dim, scale=0.1)
            u = randn(8, lay.in_caps, lay.in_dim, scale=0.5)
            r = randn(8, lay.jd, scale=0.1) if lay.residual else None
            tu = randn(16, lay.in_caps, lay.in_dim, scale=0.5)
            g = randn(16, lay.jd, scale=1e-2)
            if k > 0:
                op = serve.op(lay.name)
                sites.append((f"K3 {cfg_name} {lay.name} batch 8", op,
                              lambda op=op, u=u, w=w, r=r, kw=kw: (
                                  k34.votes_routing(
                                      u, w, r=r, mode=op.mode,
                                      block_i=op.block_i,
                                      cluster=op.cluster, **kw),)))
            bop = train.bwd_op(lay.name)
            sites.append((f"K{8 if bop.mode == 'resident' else 9} "
                          f"{cfg_name} {lay.name}-bwd batch 16", bop,
                          lambda op=bop, u=tu, w=w, g=g, kw=kw:
                          k34.votes_routing_bwd(
                              u, w, g, mode=op.mode, block_i=op.block_i,
                              cluster=op.cluster, **kw)))
        for name, op, fn in sites:
            out = fn()
            torch.cuda.synchronize()
            print(f"{name}: {op.mode} block_i {op.block_i} cluster "
                  f"{op.cluster}: {digest(*out)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
