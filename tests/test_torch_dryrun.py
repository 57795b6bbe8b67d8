"""The port's dry run (``launch/dryrun.py``) on the CPU, in a child
process (``tests/torch_dryrun_child.py``): a fake process group of the
production mesh's size must never live in the pytest process, where
``launch.mesh`` would then build a real mesh for every later test.

  * granite-3-2b's train, prefill and decode cells on the 16x16 mesh come
    back ``ok``, every tensor on the meta device, the train cell with its
    collectives, each cell's numbers consistent with its roofline;
  * the skipped cells carry the reference's reasons (encoder-only decode,
    ``long_500k`` on full attention), and the CLI prints them and exits 0;
  * DTensor's local ops: a Shard(0) x Replicate matmul on an 8-way data
    mesh counts 1/8 of the unsharded flops exactly (``FlopCounterMode``
    counts the global op), and the collective counts equal
    ``CommDebugMode``'s;
  * no process group is left in the child after a cell, nor in pytest.
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch.distributed as dist

from repro.launch.shapes import SHAPES as REF_SHAPES
from repro.launch.shapes import cell_supported as ref_supported
from repro.configs import get_config as ref_config
from repro_torch.launch import roofline as rf

ROOT = pathlib.Path(__file__).resolve().parents[1]
CELLS = ("train_4k", "prefill_32k", "decode_32k")


@pytest.fixture(scope="module")
def child(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_torch")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tests" / "torch_dryrun_child.py"),
         str(out)], capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    return json.loads(lines[-1]), lines[:-1], out


@pytest.mark.parametrize("shape", CELLS)
def test_granite_cells_run_on_meta(child, shape):
    r = child[0]["cells"][f"granite-3-2b {shape}"]
    assert r["status"] == "ok", r.get("traceback")
    assert r["devices"] == ["meta"]
    assert r["chips"] == 256 and r["mesh"] == "pod16x16"
    assert r["uncounted"] == {}
    roof = r["roofline"]
    assert roof["flops_per_device"] > 0 and roof["hbm_bytes_per_device"] > 0
    assert roof["compute_s"] == roof["flops_per_device"] / rf.PEAK_FLOPS
    assert roof["step_time_s"] == max(roof["compute_s"], roof["memory_s"],
                                      roof["collective_s"])
    mem = r["memory_analysis"]
    assert mem["total_bytes"] == sum(mem[k] for k in (
        "param_bytes", "opt_bytes", "grad_bytes", "cache_bytes",
        "activation_bytes"))
    assert mem["fits"] == (mem["total_bytes"] <= mem["device_bytes"])


def test_train_cell_has_collectives_and_its_state(child):
    r = child[0]["cells"]["granite-3-2b train_4k"]
    assert sum(r["collectives"]["counts"].values()) > 0
    assert r["collectives"]["total_bytes"] > 0
    mem = r["memory_analysis"]
    assert mem["opt_bytes"] > 0 and mem["activation_bytes"] > 0
    # fp32 gradients: the parameters' local shards again.
    assert mem["grad_bytes"] == mem["param_bytes"]
    assert r["roofline"]["model_flops"] == 6.0 * r["params_active"] * (
        256 * 4096)


def test_decode_cell_holds_its_cache(child):
    mem = child[0]["cells"]["granite-3-2b decode_32k"]["memory_analysis"]
    assert mem["cache_bytes"] > 0 and mem["opt_bytes"] == 0


@pytest.mark.parametrize("arch,shape", [("granite-3-2b", "long_500k"),
                                        ("hubert-xlarge", "decode_32k")])
def test_skipped_cells_carry_the_reference_reason(child, arch, shape):
    """The reference's reason word for word, less its pointer to a
    DESIGN.md that this repo does not hold (``launch/shapes.py``)."""
    r = child[0]["cells"][f"{arch} {shape}"]
    ok, why = ref_supported(ref_config(arch), REF_SHAPES[shape])
    assert not ok
    assert r["status"] == "skipped"
    assert r["reason"] == why.replace(" (see DESIGN.md)", "")


def test_cli_prints_the_skip_and_writes_one_json_a_cell(child):
    result, stdout, out = child
    assert result["cli_rc"] == 0
    assert any(line.startswith("[skip] hubert-xlarge") for line in stdout)
    names = {p.name for p in out.iterdir()}
    assert "granite-3-2b_train_4k_pod16x16.json" in names
    assert "hubert-xlarge_decode_32k_pod16x16.json" in names


def test_local_flops_are_a_rank_share_of_the_global_op(child):
    local = child[0]["local"]
    unsharded = 2 * 4096 * 1024 * 8192
    assert local["global_flops"] == unsharded     # FlopCounterMode: global
    assert local["flops"] * 8 == unsharded        # the counters: one rank
    assert local["devices"] == ["meta"]


def test_collective_counts_equal_comm_debug_mode(child):
    local = child[0]["local"]
    kinds = {"all_reduce": "all-reduce", "all_gather_into_tensor":
             "all-gather", "_allgather_base_": "all-gather",
             "_reduce_scatter_base_": "reduce-scatter",
             "shard_dim_alltoall": "all-to-all"}
    want = {k: 0 for k in local["counts"]}
    for name, n in local["comm_counts"].items():
        want[kinds[name.split(".")[-1]]] += n
    assert local["counts"] == want
    # The pending Partial of x.sum() is reduced inside the call: one
    # all-reduce of 4 bytes over 8 ranks, ring-accounted.
    assert local["bytes"]["all-reduce"] == 2 * 4 * 7 / 8


def test_no_process_group_is_left(child):
    result = child[0]
    assert result["local"]["group_left_inside"]
    assert not result["group_left"]
    assert not any(r["group_left"] for r in result["cells"].values())
    assert not dist.is_initialized()
