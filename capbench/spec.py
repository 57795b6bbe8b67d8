"""Finding a cell's pieces by name.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric sits in a file of its own under the benchmark's folder,
found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the configuration's sizes, source and
  precision (the ``file`` of its ``BENCHMARK.json`` entry), and its
  ``"family"`` (``capsnet`` where it names none);
- ``families/<family>.py``: what sets a cell of that family up: the
  program's CUDA libraries, the weights and the pool the traffic draws
  from, the configuration in the program's type (``families/__init__.py``);
- ``workloads/<cell>.json``: the cell's configuration, mix, parameters
  and the limits of its correctness check;
- ``mixes/<mix>.json``: the traffic mix's parameters, and the general
  driver that reads them (``"driver"``: a module of ``drivers/``);
- ``metrics/<quantity>.py``: the reader of the per-layer metrics named
  ``<quantity>`` or ``<quantity>.<cells>``, a ``read(rec)`` function
  that returns a number or None (a ``metrics/<metric>.py`` of the whole
  name, where there is one, comes first).

A new cell, mix or metric is a new file and a new ``BENCHMARK.json``
entry; no existing file changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
DEFAULT_FAMILY = "capsnet"


@dataclasses.dataclass
class Cell:
    name: str
    config: dict              # the configuration file's contents
    mix: dict                 # the traffic mix file's contents
    params: dict              # the cell's parameters (slots, rate, batch)
    limits: dict              # each compared number's limit
    end_to_end: list[dict]    # the BENCHMARK.json metrics the cell reports
    per_layer: list[dict]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise FileNotFoundError(f"no BENCHMARK.json at {root}")
    return load_json(path)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT, bench_dir: Path = HERE) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, with its files read."""
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have "
                       f"{[w['name'] for w in bench['workloads']]})")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    wl = load_json(bench_dir / "workloads" / f"{name}.json")
    if wl["config"] != entry["config"] or wl["mix"] != entry["traffic"]:
        raise ValueError(f"workloads/{name}.json names {wl['config']} / "
                         f"{wl['mix']}, BENCHMARK.json {entry['config']} / "
                         f"{entry['traffic']}")
    return Cell(
        name=name, config=load_json(root / conf["file"]),
        mix=load_json(bench_dir / "mixes" / f"{wl['mix']}.json"),
        params=wl["params"], limits=wl["limits"],
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no {path.relative_to(path.parents[1])}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str):
    """The general traffic driver ``drivers/<kind>.py``'s ``Driver``."""
    return importlib.import_module(f"capbench.drivers.{kind}").Driver


def family(name: str):
    """The family module ``families/<name>.py``.  An unknown name is
    refused, with the names there are."""
    mod = f"capbench.families.{name}"
    if isinstance(name, str) and name.isidentifier():
        try:
            return importlib.import_module(mod)
        except ModuleNotFoundError as err:
            if err.name != mod:
                raise
    have = sorted(p.stem for p in (HERE / "families").glob("*.py")
                  if not p.stem.startswith("_"))
    raise ValueError(f"unknown family {name!r} (have {have})")


def family_of(config: dict):
    """The family module of a configuration file's contents."""
    return family(config.get("family", DEFAULT_FAMILY))


def reader(metric: str, bench_dir: Path = HERE):
    """The ``read`` function of ``metrics/<metric>.py``, or else of
    ``metrics/<quantity>.py``, the quantity being the name before its
    first dot: ``mfu.offline`` and ``mfu.train`` are one reader."""
    path = bench_dir / "metrics" / f"{metric}.py"
    if not path.is_file():
        path = bench_dir / "metrics" / f"{metric.split('.')[0]}.py"
    mod = _module(path, "capbench_metric_" + path.stem.replace(".", "_"))
    return mod.read
