"""K5's producer thread tile (``execplan.pipe_tile``, the mirror of
``csrc/primary_routing.cu``'s ``tile_for``), on the CPU: every output of
the P x N tile has exactly one owning thread at every shape the kernel
takes, every thread owns outputs at the full-size CapsuleNet configs'
shapes, N = 256 keeps the 4 x 64 column-group tiles the kernel ran before,
and the shared-memory model's bytes stay the golden plans'.  No JAX; the card's own choice is held to this mirror in
``tests/test_torch_gpu.py``."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest

from repro_torch.configs import registry
from repro_torch.core.execplan import (CTA_THREADS, PIPE_MAX_CHANNELS,
                                       PIPE_MAX_POSITIONS, PIPE_TILES_BUILT,
                                       PipeTile, pipe_cluster_sizes,
                                       pipe_rows, pipe_tile,
                                       primary_routing_smem)

TESTS = Path(__file__).resolve().parent
BENCH_SVHN = TESTS.parent / "capbench" / "configs" / "capsnet-svhn.json"


def owners(tile: PipeTile, p_pos: int, n_ch: int) -> tuple[np.ndarray, int]:
    """[P, N] count of the threads that write each output, and the number
    of threads that write any: thread t computes its rows x columns when
    its first column is inside N (N splits into whole column groups) and
    writes the rows inside P, as ``produce_partial`` does."""
    count = np.zeros((p_pos, n_ch), np.int64)
    busy = 0
    for t in range(CTA_THREADS):
        rg, cg = divmod(t, tile.col_groups)
        r0, c0 = rg * tile.rows, cg * tile.cols
        if c0 >= n_ch or r0 >= p_pos:
            continue
        busy += 1
        count[r0:r0 + tile.rows, c0:c0 + tile.cols] += 1
    return count, busy


def config_shapes() -> list[tuple[str, int, int, int]]:
    """(name, P, N, C) of K5 in every CapsuleNet config of the port, its
    smoke variant, and the benchmark's published SVHN net."""
    out = []
    for arch in registry.CAPSNET_ARCHS:
        for tag, cfg in (("", registry.get_config(arch)),
                         (" smoke", registry.get_smoke_config(arch))):
            lay = cfg.routing_stack()[0]
            out.append((arch + tag, cfg.pc_out ** 2, cfg.pc_channels,
                        lay.in_dim))
    raw = json.loads(BENCH_SVHN.read_text())
    hw = (raw["image_hw"] - raw["conv1_kernel"] + 1
          - raw["pc_kernel"]) // raw["pc_stride"] + 1
    out.append(("published capsnet-svhn", hw * hw,
                raw["num_primary_groups"] * raw["primary_dim"],
                raw["primary_dim"]))
    return out


# The tile each config shape takes, and the threads that own outputs:
# every thread at the full-size configs' shapes; the smoke configs' narrow
# N (16, 24) runs the 4-column tile over 64 column groups, 4 or 6 of them
# busy in each of the 4 row groups.
EXPECTED = {(36, 256): ("9x4", 256), (64, 256): ("16x4", 256),
            (64, 96): ("4x6", 256), (16, 16): ("4x4", 16),
            (25, 16): ("8x4", 16), (25, 24): ("8x4", 24)}


@pytest.mark.parametrize("name,p_pos,n_ch,caps_dim", config_shapes(),
                         ids=[s[0] for s in config_shapes()])
def test_config_shapes_own_every_output_once(name, p_pos, n_ch, caps_dim):
    sizes = pipe_cluster_sizes(p_pos, n_ch, caps_dim)
    assert sizes, name
    for cs in sizes:            # each CTA of a cluster holds the whole tile
        tile = pipe_tile(p_pos, n_ch)
        count, busy = owners(tile, p_pos, n_ch)
        assert (count == 1).all(), (name, cs, tile)
        assert (tile.name, busy) == EXPECTED[(p_pos, n_ch)], (name, tile)
        if not name.endswith(" smoke"):
            assert busy == CTA_THREADS


def test_every_admitted_shape_owns_every_output_once():
    """P <= 64 and N <= 256, N % 4 == 0: one owner an output, a built
    tile, and no fewer threads at work than on the 4 x 64 tile."""
    built = {(t[0], t[1], t[2]) for t in PIPE_TILES_BUILT}
    for p_pos in range(1, PIPE_MAX_POSITIONS + 1):
        old = PipeTile(pipe_rows(p_pos), 4, 4, 64)
        for n_ch in range(4, PIPE_MAX_CHANNELS + 1, 4):
            tile = pipe_tile(p_pos, n_ch)
            assert (tile.rows, tile.cols, tile.col_groups) in built
            assert tile.row_groups * tile.col_groups == CTA_THREADS
            assert tile.row_groups * tile.rows == 4 * pipe_rows(p_pos)
            count, busy = owners(tile, p_pos, n_ch)
            assert (count == 1).all(), (p_pos, n_ch, tile)
            assert busy >= owners(old, p_pos, n_ch)[1], (p_pos, n_ch)


@pytest.mark.parametrize("p_pos", range(1, PIPE_MAX_POSITIONS + 1))
def test_full_width_keeps_the_four_column_tiles(p_pos):
    """N = 256 (MNIST, the repo's SVHN and CIFAR-10 stacks) runs the
    kernel's earlier tile: pipe_rows(P) rows x 4 columns over 4 x 64."""
    assert pipe_tile(p_pos, 256) == PipeTile(pipe_rows(p_pos), 4, 4, 64)


@pytest.mark.parametrize("p_pos,n_ch", [(0, 256), (65, 96), (64, 260),
                                        (64, 2)])
def test_no_tile_past_the_kernels_limits(p_pos, n_ch):
    with pytest.raises(ValueError, match="no built thread tile"):
        pipe_tile(p_pos, n_ch)


@pytest.mark.parametrize("golden", ["mnist", "svhn"])
def test_smem_model_keeps_the_golden_bytes(golden):
    """``primary_routing_smem`` (the kernel's layout: the ring's stages
    of 4 x pipe_rows(P) patch rows and 16 rows of W_pc) gives each golden
    plan's K5 footprint."""
    plans = json.loads((TESTS / f"golden_torch_{golden}_plans.json")
                       .read_text())
    arch = f"capsnet-{golden}"
    seen = 0
    for key, ops in plans.items():
        cfg = (registry.get_smoke_config(arch) if key.startswith("smoke ")
               else registry.get_config(arch))
        lay = cfg.routing_stack()[0]
        for name, kernel, block, smem, *_rest in ops:
            if kernel != "primary_routing":
                continue
            block_i, mode = _rest[1], _rest[2]
            assert primary_routing_smem(
                mode, cfg.pc_out ** 2, cfg.pc_channels, block_i, lay.in_dim,
                lay.num_caps, lay.jd, block[0]) == smem, (key, name)
            seen += 1
    assert seen >= 4


def test_launches_are_counted_by_tile():
    """``build.Kernel`` counts a launch under the kind its wrapper names
    and ``launch_kinds`` reports it; a reset clears it (no card: the
    entry is a stub)."""
    from repro_torch.kernels import build

    k = build.Kernel("primary_routing", "tile_count_probe", [])
    k._fn = lambda *args: 0
    try:
        k(kind=pipe_tile(64, 96).name)
        k(kind=pipe_tile(64, 96).name)
        k(kind=pipe_tile(36, 256).name)
        k()
        assert k.launches == 4
        assert build.launch_kinds()["tile_count_probe"] == {"4x6": 2,
                                                            "9x4": 1}
        build.reset_launch_counts()
        assert "tile_count_probe" not in build.launch_kinds()
    finally:
        del build.REGISTRY["tile_count_probe"]
