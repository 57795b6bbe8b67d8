"""Architecture registry: ``--arch <id>`` -> config module.

Counterpart of ``repro/configs/registry.py``: every arch of the
reference, the CapsuleNet archs and the LM archs (dense, MoE, MLA,
Mamba2, the hybrid and the audio encoder, ``repro_torch.models``), in
the reference's order.
"""

from __future__ import annotations

import importlib

_MODULES = {
    "gemma2-9b": "gemma2_9b",
    "gemma3-12b": "gemma3_12b",
    "granite-3-2b": "granite_3_2b",
    "gemma-7b": "gemma_7b",
    "mamba2-370m": "mamba2_370m",
    "hubert-xlarge": "hubert_xlarge",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "deepseek-v2-lite-16b": "deepseek_v2_lite",
    "chameleon-34b": "chameleon_34b",
    "zamba2-1.2b": "zamba2_1p2b",
    "capsnet-mnist": "capsnet_mnist",
    "capsnet-cifar10": "capsnet_cifar10",
    "capsnet-svhn": "capsnet_svhn",
}

# Short aliases accepted on the CLI (underscore spellings included, so
# ``--arch capsnet_mnist`` works the way the module files are named).
_ALIASES = {
    "phi3.5-moe": "phi3.5-moe-42b-a6.6b",
    "deepseek-v2-lite": "deepseek-v2-lite-16b",
    "capsnet": "capsnet-mnist",
    "capsnet_mnist": "capsnet-mnist",
    "capsnet_cifar10": "capsnet-cifar10",
    "capsnet_svhn": "capsnet-svhn",
}

LM_ARCHS = [a for a in _MODULES if not a.startswith("capsnet")]
CAPSNET_ARCHS = [a for a in _MODULES if a.startswith("capsnet")]


def canonical(name: str) -> str:
    return _ALIASES.get(name, name)


def _module(name: str):
    name = canonical(name)
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str):
    return _module(name).config()


def get_smoke_config(name: str):
    return _module(name).smoke_config()


def list_archs() -> list[str]:
    return list(_MODULES)
