"""Fault-tolerant CapsuleNet training through the port's kernels.

The counterpart of ``repro/train/capsnet_loop.py``.  The kernels'
``torch.autograd.Function``s make ``backend="kernels"`` differentiable end
to end, so the margin + masked-reconstruction loss trains through the
same plan-driven kernels that serve inference, with the backward
schedules pinned by ONE ``compile_plan(train=True, pipeline=True)``
(``self.plan``, read at every step): the forward runs Conv1 and the
pipelined PrimaryCaps->routing kernel (K5); the backward runs the routing
backward on a cluster (K8 with resident votes, K9 streamed), the conv backward
(K6 dW, K2 dpatches, K7 dx) and the recomputes (K1, K2).

Two optimizers: ``sgd`` (default; fixed ``lr``, params-only checkpoints)
and ``adam`` (AdamW + warmup/cosine from ``train.optimizer``, the horizon
as ``decay_steps``; checkpoints gain the m/v/step state).  The
checkpoint / NaN-guard / heartbeat skeleton is ``train.harness``.

A deep-stack arch (``--arch capsnet-svhn``, ``capsnet-cifar10``) trains
through the per-layer plan and the reversible ResCaps backward (K12);
the SVHN bottleneck's forward runs in K5 on the pipelined plan (K4 with
its logits in device memory, ``streamed-global``, on the per-op plan),
its backward in K9 on a cluster.

CLI (``--device cpu`` runs every kernel's plain twin):

    python -m repro_torch.train.capsnet_loop --device cpu --config smoke \\
        --backend kernels --assert-improves
    python -m repro_torch.train.capsnet_loop --arch capsnet-svhn --smoke \\
        --device cpu --backend kernels --assert-improves
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core import capsnet
from repro_torch.core.capsnet import CapsNetConfig
from repro_torch.core.execplan import compile_plan
from repro_torch.device import resolve_device
from repro_torch.train.data import DataConfig, mnist_batch
from repro_torch.train.harness import FaultTolerantLoop
from repro_torch.train.optimizer import OptConfig, adamw_update, init_opt_state

SMOKE = CapsNetConfig(image_hw=14, conv1_channels=16, conv1_kernel=5,
                      pc_kernel=3, num_primary_groups=4, primary_dim=4,
                      class_dim=8, decoder_hidden=(32, 64))
CONFIGS = {"smoke": SMOKE, "mnist": CapsNetConfig()}
OPTIMIZERS = ("sgd", "adam")


@dataclasses.dataclass
class CapsLoopConfig:
    total_steps: int = 20
    batch: int = 16
    lr: float = 3e-2
    optimizer: str = "sgd"            # "sgd" | "adam"
    warmup_steps: int = 2             # adam only
    weight_decay: float = 0.0         # adam only
    ckpt_every: int = 10
    ckpt_dir: str = "caps_checkpoints"
    keep: int = 3
    log_every: int = 5
    backend: str = "kernels"          # "kernels" | "torch"
    max_nan_skips: int = 5            # bounds CONSECUTIVE non-finite steps
    straggler_factor: float | None = None
    heartbeat_path: str | None = None
    seed: int = 0


class CapsTrainLoop(FaultTolerantLoop):
    """SGD / AdamW over ``capsnet.total_loss`` with checkpoints and the
    NaN guard, on ``device`` (``"cuda"`` unless the caller asks for the
    CPU)."""

    def __init__(self, cfg: CapsNetConfig = SMOKE,
                 loop_cfg: CapsLoopConfig = CapsLoopConfig(),
                 on_straggler=None, *, device: str | torch.device = "cuda"):
        if loop_cfg.optimizer not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {loop_cfg.optimizer!r}")
        if loop_cfg.backend not in capsnet.BACKENDS:
            raise ValueError(f"unknown backend {loop_cfg.backend!r}")
        super().__init__(loop_cfg, on_straggler=on_straggler)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.data_cfg = DataConfig(global_batch=loop_cfg.batch,
                                   seed=loop_cfg.seed)
        self.plan = (compile_plan(cfg, batch=loop_cfg.batch, train=True,
                                  pipeline=True)
                     if loop_cfg.backend == "kernels" else None)
        self.opt_cfg = (OptConfig(peak_lr=loop_cfg.lr,
                                  warmup_steps=loop_cfg.warmup_steps,
                                  decay_steps=loop_cfg.total_steps,
                                  weight_decay=loop_cfg.weight_decay)
                        if loop_cfg.optimizer == "adam" else None)
        kw = dict(backend=loop_cfg.backend, device=self.device)

        if self.opt_cfg is not None:
            def step_fn(params, opt, images, labels):
                grads, metrics = capsnet.loss_and_grads(
                    params, images, labels, cfg, plan=self.plan, **kw)
                params, opt, opt_m = adamw_update(params, grads, opt,
                                                  self.opt_cfg)
                return params, opt, {**metrics, **opt_m}
        else:
            def step_fn(params, images, labels):
                return capsnet.train_step(params, images, labels, cfg,
                                          loop_cfg.lr, plan=self.plan, **kw)
        self._step_fn = step_fn

    # -- harness hooks ---------------------------------------------------------
    def init_params(self) -> dict[str, torch.Tensor]:
        return capsnet.init_params(
            torch.Generator().manual_seed(self.loop_cfg.seed), self.cfg,
            device=self.device)

    def _init_state(self) -> dict:
        params = self.init_params()
        if self.opt_cfg is not None:
            return {"params": params, "opt": init_opt_state(params)}
        return {"params": params}

    def _ckpt_extra(self) -> dict:
        return {"backend": self.loop_cfg.backend,
                "optimizer": self.loop_cfg.optimizer}

    def _next_batch(self, step: int) -> dict[str, torch.Tensor]:
        batch = mnist_batch(self.data_cfg, step, image_hw=self.cfg.image_hw,
                            channels=self.cfg.in_channels)
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    def _run_step(self, state: dict, batch) -> tuple[dict, dict]:
        if "opt" in state:
            params, opt, metrics = self._step_fn(
                state["params"], state["opt"], batch["images"],
                batch["labels"])
            return {"params": params, "opt": opt}, metrics
        params, metrics = self._step_fn(state["params"], batch["images"],
                                        batch["labels"])
        return {"params": params}, metrics

    def _extra_record(self, metrics: dict) -> dict:
        rec = {"accuracy": float(metrics["accuracy"])}
        if "lr" in metrics:
            rec["lr"] = float(metrics["lr"])
        return rec

    def _log_line(self, rec: dict) -> str:
        return (f"step {rec['step']:6d} loss {rec['loss']:9.4f} "
                f"acc {rec['accuracy']:5.2f} {rec['time_s'] * 1e3:7.1f} ms")


def loss_ends(hist: list[dict]) -> tuple[float, float]:
    """Mean loss of the first three and of the last three steps."""
    return (float(np.mean([h["loss"] for h in hist[:3]])),
            float(np.mean([h["loss"] for h in hist[-3:]])))


def improved(hist: list[dict], nan_skips: int) -> bool:
    """The ``--assert-improves`` gate: the loss fell (``loss_ends``) and
    no rollback fired."""
    first, last = loss_ends(hist)
    return last < first and nan_skips == 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-2)
    ap.add_argument("--optimizer", choices=OPTIMIZERS, default="sgd",
                    help="sgd: fixed-lr SGD (default); adam: AdamW + "
                         "warmup/cosine from train.optimizer")
    ap.add_argument("--backend", choices=capsnet.BACKENDS,
                    default="kernels")
    ap.add_argument("--config", choices=sorted(CONFIGS), default="smoke")
    ap.add_argument("--arch", default=None,
                    help="registry architecture id (capsnet-mnist, "
                         "capsnet-cifar10, capsnet-svhn); overrides "
                         "--config.  Deep-stack archs train through the "
                         "per-layer plan and the reversible backward.")
    ap.add_argument("--smoke", action="store_true",
                    help="with --arch: the arch's smoke_config() (toy "
                         "widths, same topology)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu runs every kernel's plain PyTorch twin")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="caps_checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--assert-improves", action="store_true",
                    help="exit nonzero unless the loss decreased and no "
                         "NaN-guard rollback fired")
    args = ap.parse_args(argv)

    if args.arch is not None:
        if registry.canonical(args.arch) in registry.LM_ARCHS:
            ap.error(f"{args.arch} is an LM arch: LM training is not "
                     f"ported yet (ROADMAP queue 1, item 11a)")
        try:
            cfg = (registry.get_smoke_config(args.arch) if args.smoke
                   else registry.get_config(args.arch))
        except KeyError as err:
            ap.error(str(err))
    else:
        cfg = CONFIGS[args.config]
    loop = CapsTrainLoop(cfg, CapsLoopConfig(
        total_steps=args.steps, batch=args.batch, lr=args.lr,
        optimizer=args.optimizer, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir, backend=args.backend, seed=args.seed),
        device=args.device)
    hist = loop.run(resume=not args.no_resume)
    if not hist:
        print("nothing to do (already at the requested step)")
        return 0
    first, last = loss_ends(hist)
    step_ms = 1e3 * float(np.median([h["time_s"] for h in hist]))
    print(f"loss {first:.4f} -> {last:.4f} over {len(hist)} steps "
          f"({loop.nan_skips} NaN-guard rollbacks), median step "
          f"{step_ms:.2f} ms on {loop.device}")
    if args.assert_improves and not improved(hist, loop.nan_skips):
        print("FAIL: loss did not decrease (or a NaN rollback fired)")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
