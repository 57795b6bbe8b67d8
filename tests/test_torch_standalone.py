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
SOURCES = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
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
    from repro_torch.convert import params_from_numpy
    from repro_torch.core import capsnet
    from repro_torch.serve.capsule import CapsuleEngine

    cfg = capsnet_mnist.smoke_config()
    params = capsnet.init_params(torch.Generator().manual_seed(0), cfg,
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
    }


@pytest.mark.parametrize("entry", ["forward", "forward-kernels",
                                   "init_params", "params_from_numpy",
                                   "CapsuleEngine"])
def test_entry_points_need_a_card_unless_asked_for_the_cpu(entry,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[entry]()
