"""The port stands alone: no module of ``repro_torch`` nor ``chip_smoke.py``
imports JAX or the JAX package, every module imports without CUDA, nvcc
or Triton, and every entry point refuses to fall back to the CPU."""

import ast
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "src" / "repro_torch"
SOURCES = sorted(PACKAGE.rglob("*.py")) + [
    ROOT / name for name in ("chip_smoke.py", "cluster_bits.py",
                             "conv_gather_times.py")]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_imports_nothing_of_jax_or_the_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize(
    "path", sorted(PACKAGE.rglob("*.py")),
    ids=lambda p: str(p.relative_to(PACKAGE.parent)))
def test_every_module_imports_without_a_card(path):
    rel = path.relative_to(PACKAGE.parent).with_suffix("")
    name = ".".join(p for p in rel.parts if p != "__init__")
    importlib.import_module(name)


def test_the_scan_sees_every_kind_of_import():
    src = "import jax.numpy\nfrom repro.core import capsnet\nimport repro_torch"
    assert [m.split(".")[0] for m in _imported(ast.parse(src))] == [
        "jax", "repro", "repro_torch"]


def _entry_points():
    from repro_torch.configs import capsnet_mnist
    from repro_torch.convert import opt_state_from_numpy, params_from_numpy
    from repro_torch.core import capsnet
    from repro_torch.serve.capsule import CapsuleEngine
    from repro_torch.train import capsnet_loop

    from repro_torch.configs import registry
    from repro_torch.convert import lm_params_from_numpy
    from repro_torch.models import init_model
    from repro_torch.serve.engine import ServeEngine

    cfg = capsnet_mnist.smoke_config()
    params = capsnet.init_params(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    lm_cfg = registry.get_smoke_config("granite-3-2b")
    lm_params = init_model(torch.Generator().manual_seed(0), lm_cfg,
                           device="cpu")

    images = np.zeros((1, cfg.image_hw, cfg.image_hw, 1), np.float32)
    return {
        "forward": lambda: capsnet.forward(params, images, cfg),
        "forward-kernels": lambda: capsnet.forward(params, images, cfg,
                                                   backend="kernels"),
        "init_params": lambda: capsnet.init_params(
            torch.Generator().manual_seed(0), cfg),
        "params_from_numpy": lambda: params_from_numpy(
            {"w": np.zeros(3, np.float32)}),
        "CapsuleEngine": lambda: CapsuleEngine(params, cfg),
        "total_loss": lambda: capsnet.total_loss(params, images, [0], cfg),
        "opt_state_from_numpy": lambda: opt_state_from_numpy(
            {"m": {}, "v": {}, "step": 0}),
        "CapsTrainLoop": lambda: capsnet_loop.CapsTrainLoop(
            capsnet_loop.SMOKE, capsnet_loop.CapsLoopConfig(total_steps=1)),
        "capsnet_loop.main": lambda: capsnet_loop.main(["--steps", "1"]),
        "ServeEngine": lambda: ServeEngine(lm_params, lm_cfg),
        "models.init_model": lambda: init_model(
            torch.Generator().manual_seed(0), lm_cfg),
        "lm_params_from_numpy": lambda: lm_params_from_numpy(
            {"embed": np.zeros((4, 2), np.float32), "prefix": []}),
    }


@pytest.mark.parametrize("entry", ["forward", "forward-kernels",
                                   "init_params", "params_from_numpy",
                                   "CapsuleEngine", "total_loss",
                                   "opt_state_from_numpy", "CapsTrainLoop",
                                   "capsnet_loop.main", "ServeEngine",
                                   "models.init_model",
                                   "lm_params_from_numpy"])
def test_entry_points_need_a_card_unless_asked_for_the_cpu(entry,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[entry]()


@pytest.mark.parametrize("op", ["rmsnorm", "flash_attention"])
def test_lm_kernel_wrappers_never_fall_back_to_the_twin(op):
    """A tensor that is not on the CPU reaches the kernel or raises: the
    wrappers take the twin only for CPU tensors."""
    from repro_torch.kernels import ops
    x = torch.zeros(1, 2, 4, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        if op == "rmsnorm":
            ops.rmsnorm(x, torch.zeros(16, device="meta"))
        else:
            ops.flash_attention(x, x, x)
