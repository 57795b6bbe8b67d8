"""What the benchmark refuses: JAX or the JAX package in its process, a
machine without a card, a checkout without the program."""

import json
import shutil
import subprocess
import sys

from capbench import spec

MODULES = ["capbench.run", "capbench.harness", "capbench.spec",
           "capbench.inputs", "capbench.trace", "capbench.work",
           "capbench.faults", "capbench.drivers.serve",
           "capbench.drivers.train", "capbench.reference.capsnet_ref",
           "repro_torch.serve.capsule", "repro_torch.core.capsnet",
           "repro_torch.core.execplan", "repro_torch.kernels.build",
           "repro_torch.kernels.ops"]


def test_nothing_the_run_loads_is_jax_or_the_jax_package():
    code = (
        "import sys, importlib; sys.path[:0] = ['.', 'src']\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "from capbench import spec\n"
        "for m in spec.benchmark()['per_layer']: spec.reader(m['name'])\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, check=True)
    names = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_forbidden_names_compare_whole():
    import importlib.util
    spec_ = importlib.util.spec_from_file_location("capbench_run",
                                                   spec.HERE / "run.py")
    run = importlib.util.module_from_spec(spec_)
    saved = list(sys.path)
    try:
        spec_.loader.exec_module(run)
    finally:
        sys.path[:] = saved
    assert run.forbidden_modules(["repro_torch", "repro_torch.core",
                                  "reprolike", "jaxtyping", "torch"]) == []
    assert run.forbidden_modules(["jax.numpy", "repro.core", "flax",
                                  "jaxlib.xla_client"]) == [
        "flax", "jax", "jaxlib", "repro"]


def run_cmd(cwd):
    return subprocess.run(
        [sys.executable, "capbench/run.py", "--workload", "mnist-offline",
         "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})


def test_without_a_card_the_run_fails_and_prints_no_result():
    out = run_cmd(spec.ROOT)
    assert out.returncode != 0
    assert "CUDA" in out.stderr
    assert out.stdout.strip() == ""


def test_without_the_program_the_run_fails(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "capbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run_cmd(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_the_contract_of_benchmark_json():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["capbench"]
    names = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in names
        for w in m["workloads"]:
            e2e = [e for e in bench["end_to_end"] if e["name"] == m["moves"]]
            assert w in e2e[0].get("workloads", [w])
    for w in bench["workloads"]:
        assert (spec.HERE / "workloads" / f"{w['name']}.json").is_file()
        assert len(w["why"]) <= 200 and w["chips"] == 1
