"""Architecture registry: ``--arch <id>`` -> config module.

Counterpart of ``repro/configs/registry.py`` for the CapsuleNet archs.
The reference's LM archs are not ported yet: asking for one raises
``KeyError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import importlib

_MODULES = {
    "capsnet-mnist": "capsnet_mnist",
    "capsnet-cifar10": "capsnet_cifar10",
    "capsnet-svhn": "capsnet_svhn",
}

# Short aliases accepted on the CLI (underscore spellings included, so
# ``--arch capsnet_mnist`` works the way the module files are named).
_ALIASES = {
    "capsnet": "capsnet-mnist",
    "capsnet_mnist": "capsnet-mnist",
    "capsnet_cifar10": "capsnet-cifar10",
    "capsnet_svhn": "capsnet-svhn",
}

# The reference's LM archs (with their aliases), refused by name.
_LM_ARCHS = ("gemma2-9b", "gemma3-12b", "granite-3-2b", "gemma-7b",
             "mamba2-370m", "hubert-xlarge", "phi3.5-moe-42b-a6.6b",
             "phi3.5-moe", "deepseek-v2-lite-16b", "deepseek-v2-lite",
             "chameleon-34b", "zamba2-1.2b")

CAPSNET_ARCHS = list(_MODULES)


def canonical(name: str) -> str:
    return _ALIASES.get(name, name)


def _module(name: str):
    name = canonical(name)
    if name in _LM_ARCHS:
        raise KeyError(f"arch {name!r} is an LM arch of the reference; the "
                       f"LM side is not ported yet (ROADMAP queue 1, item "
                       f"11). Ported: {CAPSNET_ARCHS}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")


def get_config(name: str):
    return _module(name).config()


def get_smoke_config(name: str):
    return _module(name).smoke_config()


def list_archs() -> list[str]:
    return list(_MODULES)
