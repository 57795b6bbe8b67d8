"""A run with the timed path broken underneath comes out not correct.

Each test skips only the look for a card: set-up, the window and the
check run as on the card, at the configuration's smoke sizes on the
kernels' plain twins, with the cells' own limits."""

import pytest

from capbench import faults
from capbench.tests import helpers


@pytest.mark.parametrize("cell", ["mnist-offline", "mnist-server"])
def test_an_altered_answer_is_not_correct(cell):
    with faults.altered_answer():
        out = helpers.run_smoke(cell)
    assert out["correct"] is False
    assert out["checks"]["lengths_gap"]["value"] > 1e-4


def test_a_step_that_returns_its_state_unchanged_is_not_correct():
    with faults.unchanged_state():
        out = helpers.run_smoke("svhn-train")
    assert out["correct"] is False
    assert out["checks"]["grad_gap"]["value"] == 1.0
    assert out["checks"]["change_gap"]["value"] == 1.0


def test_half_the_batch_left_out_is_not_correct():
    with faults.half_batch():
        out = helpers.run_smoke("svhn-train")
    assert out["correct"] is False
    checks = out["checks"]
    assert checks["loss_gap"]["value"] > checks["loss_gap"]["limit"]
    assert checks["grad_gap"]["value"] > checks["grad_gap"]["limit"]
    assert checks["grad_gap"]["worst"] > 0.1
