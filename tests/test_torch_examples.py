"""The port's examples run end to end on the CPU (``--device cpu``: the
kernels' plain twins) at a small size, each in its own process, which
never imports JAX.  On the card ``chip_smoke.py`` runs them on the
kernels."""

import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

# Runs the example's main as ``python examples/<name>`` would, then
# checks that nothing of JAX entered the process.
DRIVER = """
import runpy, sys
sys.argv = [sys.argv[1]] + sys.argv[2:]
runpy.run_path(sys.argv[0], run_name="__main__")
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib")
             or m == "repro" or m.startswith("repro."))
assert not bad, f"imported {bad}"
"""


@pytest.mark.parametrize("example,args,expect", [
    ("quickstart_torch.py", ["--steps", "2", "--batch", "4"],
     "selected design: PG-SEP"),
    ("serve_capsnet_torch.py", ["--requests", "6", "--slots", "4"],
     "served 6 requests (kernels backend on cpu"),
    ("serve_capsnet_torch.py", ["--requests", "5", "--slots", "2",
                                "--use-async", "--backend", "torch"],
     "served 5 requests (torch backend on cpu, 2 slots, async)"),
    ("serve_lm_torch.py", ["--requests", "3", "--slots", "2",
                           "--max-new", "3"],
     "served 3 requests / 9 tokens"),
    ("train_lm_torch.py", ["--preset", "tiny", "--steps", "4", "--seq",
                           "32", "--batch", "4", "--ckpt-dir", "{tmp}"],
     "over 4 steps"),
    ("serve_lm_torch.py", ["--arch", "mamba2-370m", "--requests", "3",
                           "--slots", "2", "--max-new", "3"],
     "served 3 requests / 9 tokens"),
    ("serve_lm_torch.py", ["--arch", "deepseek-v2-lite", "--requests", "3",
                           "--slots", "2", "--max-new", "3"],
     "served 3 requests / 9 tokens"),
    ("train_lm_torch.py", ["--arch", "hubert-xlarge", "--steps", "4",
                           "--seq", "32", "--batch", "4", "--ckpt-dir",
                           "{tmp}"],
     "over 4 steps"),
], ids=["quickstart", "serve_capsnet", "serve_capsnet-async",
        "serve_lm", "train_lm", "serve_lm-mamba2", "serve_lm-deepseek",
        "train_lm-hubert"])
def test_example_runs_on_the_cpu_without_jax(example, args, expect,
                                             tmp_path):
    args = [a.format(tmp=tmp_path) for a in args]
    proc = subprocess.run(
        [sys.executable, "-c", DRIVER, f"examples/{example}",
         "--device", "cpu", *args],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert expect in proc.stdout, proc.stdout[-2000:]


def test_the_examples_need_a_card_unless_asked_for_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-c", DRIVER, "examples/serve_lm_torch.py"],
        capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr
