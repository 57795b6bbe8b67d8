"""Setting a cell up by its configuration's family, on the CPU: the
CapsuleNet family draws what the harness drew before families, bit for
bit, and a family that is not a CapsuleNet runs through ``run_cell``
with new modules only."""

import hashlib
import subprocess
import sys
import time
import types

import pytest
import torch

from capbench import harness, inputs, spec
from capbench.families import capsnet
from capbench.tests import helpers

SEED = 2024
CPU = torch.device("cpu")
# SHA-256 of the smoke-size weights (each name, then its float32 bytes,
# in draw order) and of the pool of helpers.POOL images and labels at
# SEED, as the harness drew them before it had families.
DIGESTS = {
    "capsnet-mnist": (
        "38bc6cb41f3d0965f47f18482522d53214ff6d414e1700ad9f32d58173381ed2",
        "47847fe1a1a30eaa6ccbeb2e1e1bb46f682eb4c172237c3896dd792ee8935fed"),
    "capsnet-svhn": (
        "19ceebcae855ab7f27bff7b26d8a1f365e3caa43bca754ffb8eb729d588652c4",
        "1f1c2e9d57398c381b73f6a4873e91c407fe610475b5b4e233c10b50bf638638"),
}


def config(name: str) -> dict:
    return spec.load_json(spec.HERE / "configs" / f"{name}.json")


def digest_weights(w: dict) -> str:
    h = hashlib.sha256()
    for k, v in w.items():
        h.update(k.encode())
        h.update(v.contiguous().numpy().tobytes())
    return h.hexdigest()


def digest_pool(x: torch.Tensor, y: torch.Tensor) -> str:
    h = hashlib.sha256()
    h.update(x.contiguous().numpy().tobytes())
    h.update(y.contiguous().numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_capsnet_family_draws_the_inputs_of_before(name):
    cfg = inputs.smoke(config(name))
    w = capsnet.weights(cfg, SEED, CPU)
    ref = inputs.weights(cfg, SEED, CPU)
    assert list(w) == list(ref)
    assert all(torch.equal(w[k], ref[k]) for k in ref)
    pool = capsnet.pool(cfg, {"pool": helpers.POOL}, SEED, CPU)
    x, y = inputs.images(cfg, helpers.POOL, SEED, CPU)
    assert set(pool) == {"images", "labels"}
    assert torch.equal(pool["images"], x) and torch.equal(pool["labels"], y)
    assert (digest_weights(w), digest_pool(x, y)) == DIGESTS[name]


class Captured(Exception):
    pass


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_run_cell_hands_the_driver_the_inputs_of_before(name, monkeypatch):
    seen = {}

    def capture(ctx):
        seen["ctx"] = ctx
        raise Captured

    monkeypatch.setattr(spec, "driver", lambda kind: capture)
    cell = next(spec.cell(w["name"]) for w in spec.benchmark()["workloads"]
                if w["config"] == name)
    cell.params = dict(cell.params, pool=helpers.POOL)
    cfg = inputs.smoke(cell.config)
    with pytest.raises(Captured):
        harness.run_cell(cell, SEED, helpers.WINDOW_S, False, device=CPU,
                         t0=time.perf_counter(), cfg=cfg)
    ctx = seen["ctx"]
    assert (digest_weights(ctx.weights),
            digest_pool(ctx.images, ctx.labels)) == DIGESTS[name]
    assert set(ctx.pool) == {"images", "labels"}
    assert ctx.pcfg == inputs.program_config(cfg)


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_a_config_without_a_family_is_a_capsnet(name):
    cfg = config(name)
    assert "family" not in cfg
    assert spec.family_of(cfg) is capsnet
    assert spec.family_of(dict(cfg, family="capsnet")) is capsnet
    assert spec.family("capsnet") is capsnet


@pytest.mark.parametrize("family", ["llama", "capsnet.sub", "../capsnet"])
def test_an_unknown_family_is_refused_before_any_weights(family,
                                                         monkeypatch):
    drawn = []
    for mod, fn in ((capsnet, "weights"), (capsnet, "pool"),
                    (inputs, "weights"), (inputs, "images")):
        monkeypatch.setattr(mod, fn, lambda *a, fn=fn: drawn.append(fn))
    cell = helpers.smoke_cell("mnist-offline")
    cfg = dict(inputs.smoke(cell.config), family=family)
    with pytest.raises(ValueError) as err:
        harness.run_cell(cell, SEED, helpers.WINDOW_S, False, device=CPU,
                         t0=time.perf_counter(), cfg=cfg)
    assert repr(family) in str(err.value) and "capsnet" in str(err.value)
    assert drawn == []


# A family that is not a CapsuleNet, and a driver for it: rows of the
# pool through one weight matrix, the check against float64.
def stub_family() -> types.ModuleType:
    fam = types.ModuleType("capbench.families.stub")
    fam.LIBRARIES = ()
    fam.weights = lambda cfg, seed, device: {"w": torch.randn(
        cfg["width"], cfg["width"],
        generator=inputs.generator(seed, device, 1), device=device)}
    fam.pool = lambda cfg, params, seed, device: {"rows": torch.rand(
        (params["rows"], cfg["width"]),
        generator=inputs.generator(seed, device, 2), device=device)}
    fam.program_config = lambda cfg: ("stub", cfg["width"])
    return fam


class StubDriver:
    def __init__(self, ctx):
        assert ctx.pcfg == ("stub", ctx.cfg["width"])
        self.ctx = ctx
        self.out = None
        self.steps = 0

    def window(self, seconds, span):
        t0 = time.perf_counter()
        while True:
            with span("capbench.step"):
                self.out = self.ctx.rows @ self.ctx.weights["w"]
            self.steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        return dict(wall_s=time.perf_counter() - t0, steps=self.steps)

    def drain(self):
        pass

    def counts(self):
        return self.steps, 0

    def end_to_end(self, rec):
        return {"rows_per_s": rec["steps"] * len(self.ctx.rows)
                / rec["wall_s"]}

    def notes(self, rec):
        return {"window": f"{rec['steps']} steps"}

    def check(self, precision="fp32"):
        ref = self.ctx.rows.double() @ self.ctx.weights["w"].double()
        gap = float((self.out.double() - ref).abs().max() / ref.abs().max())
        return {"rows_gap": {"value": gap,
                             "limit": self.ctx.limits["rows_gap"]}}


def test_a_new_family_runs_through_run_cell_with_new_modules_only(
        monkeypatch):
    drivers = types.ModuleType("capbench.drivers.stub")
    drivers.Driver = StubDriver
    monkeypatch.setitem(sys.modules, "capbench.families.stub", stub_family())
    monkeypatch.setitem(sys.modules, "capbench.drivers.stub", drivers)
    cell = spec.Cell(
        name="stub-rows", config={"name": "stub", "family": "stub",
                                  "width": 16},
        mix={"driver": "stub"}, params={"rows": 32},
        limits={"rows_gap": 1e-5},
        end_to_end=[{"name": "rows_per_s", "unit": "rows/s"},
                    {"name": "setup_s", "unit": "s"}],
        per_layer=[])
    out = harness.run_cell(cell, 3_000_000_017, helpers.WINDOW_S, False,
                           device=CPU, t0=time.perf_counter())
    assert out["correct"] is True
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"rows_per_s", "setup_s"}
    assert out["metrics"]["rows_per_s"]["value"] > 0
    assert out["checks"]["rows_gap"]["value"] < 1e-5


def test_nothing_the_family_loads_is_jax_or_the_jax_package():
    code = (
        "import sys; sys.path[:0] = ['.', 'src']\n"
        "from capbench import spec\n"
        "from capbench import inputs\n"
        "cfg = spec.cell('mnist-offline').config\n"
        "spec.family_of(cfg).program_config(inputs.smoke(cfg))\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, check=True)
    names = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}
