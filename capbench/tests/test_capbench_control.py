"""The control, the reference in TF32 put in the program's place, comes
out not correct under each cell's limits; the program does not.

At smoke sizes on the CPU, where TF32 is emulated by rounding every
matmul and convolution operand to its 10-bit mantissa (on the card the
control runs in cuBLAS's and cuDNN's TF32)."""

import pytest

from capbench.tests import helpers

CELLS = ["mnist-offline", "svhn-offline", "mnist-server", "svhn-train"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_and_the_program_passes(cell):
    out = helpers.run_smoke(cell, control=True)
    control = out["control_checks"]
    assert any(c["value"] > c["limit"] for c in control.values())
    for name, c in out["checks"].items():
        if cell == "svhn-train" and name == "change_gap":
            # At smoke sizes a 3-step change is a few ulps of the weights
            # it moves, so round-off alone can reach 1e-4 on some seeds:
            # held against the control's reading, not the full-size limit.
            assert c["value"] < control[name]["value"]
        else:
            assert c["value"] <= c["limit"], name
    assert out["failed"] == 0
