#!/usr/bin/env python3
"""K1 (im2col) and K7 (col2im) at ``chip_smoke.py``'s sites, and the device
time of the paths that run them, for one checkout on one NVIDIA GPU.

    python3 conv_gather_times.py [CHECKOUT]

It imports the ``repro_torch`` package of CHECKOUT (default: the checkout
this script lies in) and the timing helpers of the ``chip_smoke.py``
beside this script.  On seeded inputs made with numpy it prints one line a
site: the kernel's device ms with the L2 warm and cold, the byte bound and
its share, and the SHA-256 of the output (the same digest in two
checkouts means the same bits).  Then one line a path, the device ms by
kernel of: the MNIST CapsuleNet's pipelined forward at batch 8 and its
gradient at 16, and capsnet-svhn's per-op and pipelined forward at 8 and
gradient at 16, each with K1's and K7's part.  Run it for two checkouts
in one call, in turns (parent, change, change, parent), to compare them.
It imports nothing of JAX, and exits non-zero without a CUDA device.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

SEED = 0
GATHERS = ("im2col_kernel", "col2im_kernel")


def digest(t) -> str:
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()
                          ).hexdigest()[:16]


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("conv_gather_times: no CUDA device is available",
              file=sys.stderr)
        return 2
    root = Path(sys.argv[1] if len(sys.argv) > 1
                else Path(__file__).resolve().parent).resolve()
    sys.path.insert(0, str(root / "src"))
    import chip_smoke as cs
    from repro_torch.configs import capsnet_mnist, capsnet_svhn
    from repro_torch.core import capsnet, execplan
    from repro_torch.kernels import conv_im2col as k12

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"conv_gather_times: repro_torch from {root}, on {card}",
          flush=True)

    def uniform(*shape):
        return torch.tensor(rng.random(shape, np.float32), device=dev)

    def randn(*shape, scale=1.0):
        return torch.tensor(scale * rng.standard_normal(shape, np.float32),
                            device=dev)

    def site(kernel, label, fn, nbytes):
        out = fn()
        warm = cs.device_ms(fn)
        cold = cs.cold_device_ms(fn, kernel)
        bms = nbytes / cs.PEAK_HBM_BYTES * 1e3
        share = {k: (bms / v if v else None)
                 for k, v in (("warm", warm), ("cold", cold))}
        print(json.dumps(dict(site=f"{kernel} {label}", device_ms=warm,
                              cold_device_ms=cold, bound_ms=bms,
                              warm_share=share["warm"],
                              cold_share=share["cold"],
                              sha256=digest(out))), flush=True)

    mnist, svhn = capsnet_mnist.config(), capsnet_svhn.config()
    # K1: Conv1 and PrimaryCaps at the engine's batch, SVHN's also at the
    # trainer's; K7: each PrimaryCaps dx at the trainer's batch.
    for cfg, name, batches in ((mnist, "MNIST", (8,)),
                               (svhn, "SVHN", (8, 16))):
        for b in batches:
            for label, shape, k, s in (
                    ("Conv1", (b, cfg.image_hw, cfg.image_hw,
                               cfg.in_channels), cfg.conv1_kernel, 1),
                    ("PrimaryCaps", (b, cfg.conv1_out, cfg.conv1_out,
                                     cfg.conv1_channels), cfg.pc_kernel,
                     cfg.pc_stride)):
                x = uniform(*shape)
                oh = (shape[1] - k) // s + 1
                site("im2col_kernel", f"{label} ({name}, {b})",
                     lambda x=x, k=k, s=s: k12.im2col_patches(
                         x, kh=k, kw=k, stride=s),
                     4.0 * (x.numel() + b * oh * oh * k * k * shape[3]))
        hw, kp = cfg.conv1_out, cfg.pc_kernel
        dp = randn(16, cfg.pc_out ** 2, kp * kp * cfg.conv1_channels,
                   scale=1e-3)
        site("col2im_kernel", f"PrimaryCaps-bwd ({name}, 16)",
             lambda dp=dp, hw=hw, kp=kp, cfg=cfg: k12.col2im_patches(
                 dp, kh=kp, kw=kp, stride=cfg.pc_stride, h=hw, w=hw),
             4.0 * (dp.numel() + 16 * hw * hw * cfg.conv1_channels))

    # The paths, by kernel.
    for cfg, name, plans in ((mnist, "MNIST", (True,)),
                             (svhn, "SVHN", (False, True))):
        params = capsnet.init_params(torch.Generator().manual_seed(SEED),
                                     cfg, device=dev)
        shape = (cfg.image_hw, cfg.image_hw, cfg.in_channels)
        images, timages = uniform(8, *shape), uniform(16, *shape)
        labels = torch.tensor(rng.integers(0, cfg.num_classes, 16),
                              device=dev)
        paths = []
        for pipe in plans:
            plan = execplan.compile_plan(cfg, batch=8, pipeline=pipe)
            paths.append((f"{name} forward, "
                          f"{'pipelined' if pipe else 'per-op'} plan, 8",
                          lambda plan=plan: capsnet.forward(
                              params, images, cfg, backend="kernels",
                              plan=plan, device=dev)))
        tplan = execplan.compile_plan(cfg, batch=16, pipeline=True,
                                      train=True)
        paths.append((f"{name} gradient, pipelined train plan, 16",
                      lambda: capsnet.loss_and_grads(
                          params, timages, labels, cfg, backend="kernels",
                          plan=tplan, device=dev)))
        for label, fn in paths:
            with torch.set_grad_enabled(label.startswith(f"{name} grad")):
                split = cs.device_breakdown(fn, reps=10, top=100) or {}
            gathers = {g: sum(v for k, v in split.items() if g in k)
                       for g in GATHERS}
            print(json.dumps(dict(path=label, device_ms=split.get("total"),
                                  **gathers, by_kernel=split)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
