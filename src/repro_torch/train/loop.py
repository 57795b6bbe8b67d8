"""Fault-tolerant LM training loop: the counterpart of
``repro/train/loop.py``.

``TrainLoop`` binds ``train.harness.FaultTolerantLoop`` (async atomic
checkpoints, resume from the latest committed step, NaN/divergence
rollback to this run's last commit, preemption through
``request_stop()`` or SIGTERM, a JSON heartbeat, the straggler hook) to
the LM objective: ``launch.steps.make_train_step`` (fp32 masters, the
forward and backward in bf16, AdamW in place) and the
``DataIterator`` stream, skipped ahead deterministically on a resume and
past a poisoned batch on a rollback.

The loop runs on the card unless ``device="cpu"`` is given; batches move
to its device as they are drawn.  It trains on ``backend="torch"`` (K15
and K16 have no backward; ``make_train_step`` refuses ``"kernels"``).

Sharded: with ``shd`` (``parallel.sharding.ShardingCtx``) and
``param_shardings`` (``parallel.sharding.param_shardings``) the loop
runs one process a rank (``parallel.ranks.run_ranks``), every rank with
the same seed and the same data: the parameters are placed by
``param_shardings`` and the AdamW moments follow them.  Rank 0 writes
full tensors; a restore places every leaf by ``param_shardings``, so a
checkpoint written on one mesh resumes on another (the elastic
restore).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import init_model
from repro_torch.parallel.sharding import place_tree
from repro_torch.train.data import DataConfig, DataIterator
from repro_torch.train.harness import FaultTolerantLoop
from repro_torch.train.optimizer import OptConfig, init_opt_state


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = "checkpoints"
    keep: int = 3
    log_every: int = 10
    heartbeat_path: str | None = None
    straggler_factor: float = 3.0
    max_nan_skips: int = 5
    seed: int = 0


class TrainLoop(FaultTolerantLoop):
    def __init__(self, model_cfg: ModelConfig, opt_cfg: OptConfig,
                 data_cfg: DataConfig, loop_cfg: LoopConfig,
                 shd=None, param_shardings=None,
                 on_straggler: Callable[[int, float], None] | None = None,
                 *, device: str | torch.device = "cuda",
                 backend: str = "torch"):
        self.device = resolve_device(device)
        super().__init__(loop_cfg, on_straggler=on_straggler)
        self.model_cfg = model_cfg
        self.opt_cfg = opt_cfg
        self.data_cfg = data_cfg
        self.shd = shd
        self.param_shardings = param_shardings
        self._data: DataIterator | None = None
        self._step_fn = make_train_step(model_cfg, opt_cfg, shd,
                                        backend=backend)

    # -- state ----------------------------------------------------------------
    def init_state(self) -> tuple[Any, Any]:
        gen = torch.Generator(device=self.device).manual_seed(
            self.loop_cfg.seed)
        params = init_model(gen, self.model_cfg, device=self.device)
        if self.param_shardings is not None:
            params = place_tree(params, self.param_shardings)
        return params, init_opt_state(params)

    def try_restore(self, params, opt_state):
        state, start = self._try_restore({"params": params,
                                          "opt": opt_state})
        return state["params"], state["opt"], start

    # -- harness hooks ---------------------------------------------------------
    def _init_state(self) -> dict:
        params, opt_state = self.init_state()
        return {"params": params, "opt": opt_state}

    def _shardings(self):
        """The state's placements for a restore: the moments as their
        parameters, the step count plain."""
        ps = self.param_shardings
        if ps is None:
            return None
        return {"params": ps, "opt": {"m": ps, "v": ps, "step": None}}

    def _ckpt_extra(self) -> dict:
        return {"model": self.model_cfg.name}

    def _begin(self, start: int) -> None:
        self._data = DataIterator(self.data_cfg, start_step=start)

    def _next_batch(self, step: int) -> dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in next(self._data).items()}

    def _skip_batch(self, step: int) -> None:
        self._data.skip_to(step)

    def _run_step(self, state: dict, batch) -> tuple[dict, dict]:
        params, opt_state, metrics = self._step_fn(state["params"],
                                                   state["opt"], batch)
        return {"params": params, "opt": opt_state}, metrics

    def _extra_record(self, metrics: dict) -> dict:
        return {"grad_norm": float(metrics["grad_norm"])}

    def _log_line(self, rec: dict) -> str:
        return (f"step {rec['step']:6d} loss {rec['loss']:9.4f} "
                f"gnorm {rec['grad_norm']:8.3f} {rec['time_s']*1e3:7.1f} ms")
