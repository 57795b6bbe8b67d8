"""Shared cases of the port's multi-rank LM tests: the reference's smoke
parameters as numpy trees, a seeded batch, and the unsharded port step
they are held to.  Not a test module itself (no ``test_`` prefix)."""

import functools

import jax
import numpy as np
import torch

import torch_ranks
from repro.configs import get_smoke_config as ref_smoke
from repro.models import init_model as ref_init
from repro_torch.configs import registry
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import steps
from repro_torch.train import optimizer

RTOL_SHARDED = 2e-4       # the reference's sharded-vs-single bound


@functools.lru_cache(maxsize=None)
def case(arch):
    """(numpy reference params, a seeded [4, 32] batch) of ``arch``."""
    rp = ref_init(jax.random.PRNGKey(0), ref_smoke(arch))
    cfg = registry.get_smoke_config(arch)
    rng = np.random.default_rng(11)
    batch = {k: rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int64)
             for k in ("inputs", "targets")}
    return jax.tree_util.tree_map(np.asarray, rp), batch


def port_step(arch):
    """The unsharded port step's metrics from ``case(arch)``."""
    np_params, batch = case(arch)
    cfg = registry.get_smoke_config(arch)
    params = lm_params_from_numpy(np_params, "cpu")
    opt = optimizer.init_opt_state(params)
    _, _, m = steps.make_train_step(
        cfg, optimizer.OptConfig(**torch_ranks.OPT),
        compute_dtype=torch.float32)(
            params, opt, {k: torch.from_numpy(v) for k, v in batch.items()})
    return {k: float(v) for k, v in m.items()}
