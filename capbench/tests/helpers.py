"""Shared by the benchmark's CPU tests: a cell at its configuration's
smoke sizes, run on the kernels' plain twins."""

import time

import torch

from capbench import harness, inputs, spec

WINDOW_S = 0.2
POOL = 256
RATE = 300.0
BATCH = 64          # training: four distinct batches in the smoke pool


def smoke_cell(name: str) -> spec.Cell:
    cell = spec.cell(name)
    cell.params = dict(cell.params, pool=POOL)
    if "rate_per_s" in cell.params:
        cell.params["rate_per_s"] = RATE
    if "batch" in cell.params:
        cell.params["batch"] = BATCH
    return cell


def run_smoke(name: str, seed: int = 2024, control: bool = False) -> dict:
    cell = smoke_cell(name)
    return harness.run_cell(cell, seed, WINDOW_S, False,
                            device=torch.device("cpu"),
                            t0=time.perf_counter(),
                            cfg=inputs.smoke(cell.config), control=control)
