"""Architecture registry: ``--arch <id>`` -> config module.

Counterpart of ``repro/configs/registry.py``: the CapsuleNet archs and
the LM archs whose blocks the port runs (attention with a dense or an
MoE MLP, ``repro_torch.models``).  The reference's other LM archs raise
``KeyError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import importlib

_MODULES = {
    "gemma2-9b": "gemma2_9b",
    "gemma3-12b": "gemma3_12b",
    "granite-3-2b": "granite_3_2b",
    "gemma-7b": "gemma_7b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "chameleon-34b": "chameleon_34b",
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

# The reference's LM archs not ported yet, each with the ROADMAP item
# (queue 1) that ports it.
_WAITING = {
    "deepseek-v2-lite-16b": "item 11c, MLA",
    "mamba2-370m": "item 11d, mamba and hybrid",
    "zamba2-1.2b": "item 11d, mamba and hybrid",
    "hubert-xlarge": "item 11e, hubert",
}

LM_ARCHS = [a for a in _MODULES if not a.startswith("capsnet")]
CAPSNET_ARCHS = [a for a in _MODULES if a.startswith("capsnet")]


def canonical(name: str) -> str:
    return _ALIASES.get(name, name)


def _module(name: str):
    name = canonical(name)
    if name in _WAITING:
        raise KeyError(f"arch {name!r} of the reference is not ported yet "
                       f"(ROADMAP queue 1, {_WAITING[name]}); ported: "
                       f"{list(_MODULES)}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str):
    return _module(name).config()


def get_smoke_config(name: str):
    return _module(name).smoke_config()


def list_archs() -> list[str]:
    return list(_MODULES)
