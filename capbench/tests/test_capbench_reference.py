"""The benchmark's plain reference against the program's plain path, at
each configuration's smoke sizes on the CPU, on the same seeded weights."""

import subprocess
import sys

import pytest
import torch

from capbench import inputs, spec
from capbench.reference import capsnet_ref

CONFIGS = ["capsnet-mnist", "capsnet-svhn"]
# Sabour et al. 2017's SVHN network: the widths its section 7 states.
PUBLISHED = {"capsnet-svhn": {"image_hw": 32, "in_channels": 3,
                              "conv1_channels": 64, "num_primary_groups": 16,
                              "primary_dim": 6, "num_classes": 10,
                              "class_dim": 8, "caps_layers": []}}


def config(name: str) -> dict:
    return spec.load_json(spec.HERE / "configs" / f"{name}.json")


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_file_is_the_programs(name, smoke):
    """A configuration the program ships (``"program"``) is the program's
    own; one it does not ship is at its published widths, and the
    program's type takes it as it stands."""
    from repro_torch.configs import registry
    cfg = config(name)
    built = inputs.program_config(inputs.smoke(cfg) if smoke else cfg)
    if cfg["program"] is not None:
        assert built == (registry.get_smoke_config(name) if smoke
                         else registry.get_config(name))
    else:
        assert {k: cfg[k] for k in PUBLISHED[name]} == PUBLISHED[name]
        assert built.num_primary_groups == (
            cfg["smoke"] if smoke else cfg)["num_primary_groups"]


@pytest.mark.parametrize("name", CONFIGS)
def test_weights_follow_the_programs_names_and_shapes(name):
    from repro_torch.core import capsnet
    cfg = inputs.smoke(config(name))
    ours = inputs.weights(cfg, 5, torch.device("cpu"))
    theirs = capsnet.init_params(torch.Generator().manual_seed(0),
                                 inputs.program_config(cfg), device="cpu")
    assert {k: v.shape for k, v in ours.items()} == {
        k: v.shape for k, v in theirs.items()}
    again = inputs.weights(cfg, 5, torch.device("cpu"))
    assert all(torch.equal(ours[k], again[k]) for k in ours)


@pytest.mark.parametrize("name", CONFIGS)
def test_lengths_match_the_plain_path(name):
    from repro_torch.core import capsnet
    cfg = inputs.smoke(config(name))
    dev = torch.device("cpu")
    w = inputs.weights(cfg, 11, dev)
    x, _ = inputs.images(cfg, 8, 11, dev)
    got = capsnet.forward(w, x, inputs.program_config(cfg), backend="torch",
                          device="cpu")["lengths"]
    with torch.no_grad():
        ref = capsnet_ref.lengths(w, x, cfg)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", CONFIGS)
def test_sgd_step_matches_the_plain_path(name):
    from repro_torch.core import capsnet
    cfg = inputs.smoke(config(name))
    dev = torch.device("cpu")
    w = inputs.weights(cfg, 12, dev)
    x, y = inputs.images(cfg, 8, 12, dev)
    new, grads, loss = capsnet_ref.sgd_step(w, x, y, cfg, 0.03)
    prog = {k: v.clone() for k, v in w.items()}
    _, metrics = capsnet.train_step(prog, x, y, inputs.program_config(cfg),
                                    0.03, backend="torch", device="cpu")
    assert loss == pytest.approx(float(metrics["loss"]), rel=1e-6)
    for k in w:
        torch.testing.assert_close(prog[k], new[k], rtol=1e-5, atol=1e-7)


def test_round_tf32():
    one = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                        1.0 + 2.0 ** -10 + 2.0 ** -11, -(1.0 + 3 * 2.0 ** -12)])
    got = capsnet_ref.round_tf32(one)
    want = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                         -(1.0 + 2.0 ** -10)])
    assert torch.equal(got, want)
    assert int((got.view(torch.int32) & 0x1FFF).abs().sum()) == 0


def test_tf32_control_departs_from_fp32():
    cfg = config("capsnet-mnist")
    dev = torch.device("cpu")
    w = inputs.weights(cfg, 3, dev)
    x, _ = inputs.images(cfg, 2, 3, dev)
    with torch.no_grad():
        a = capsnet_ref.lengths(w, x, cfg)
        b = capsnet_ref.lengths(w, x, cfg, capsnet_ref.Precision("tf32"))
    gap = float(((a - b).abs().amax(1) / a.abs().amax(1)).max())
    assert 1e-5 < gap < 1e-2


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = ['.']; "
            "import capbench.reference.capsnet_ref; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, check=True)
    names = set(eval(out.stdout))
    assert not names & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
