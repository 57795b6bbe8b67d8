"""Seeded-violation tests for the port's contract lint
(``repro_torch.verify.lint``), after ``tests/test_verify_lint.py``.

Each rule gets source snippets that MUST trip it and minimally corrected
twins that must pass -- linted as strings, never imported.  Where the two
lints share a rule unchanged (``unbounded-cache``, ``nameless-plan-error``)
the port's finds exactly the reference's violations.
"""

from pathlib import Path

import pytest

import repro_torch
from repro.verify.lint import lint_source as ref_lint_source
from repro_torch.verify import lint_repo, lint_source
from repro_torch.verify.lint import _roles_for

ROOT = Path(__file__).resolve().parents[1]


def _rules(violations):
    return {v.rule for v in violations}


# ---------------------------------------------------------------------------
# unbounded-cache
# ---------------------------------------------------------------------------

class TestUnboundedCache:

    def test_functools_cache_is_flagged(self):
        src = ("import functools\n"
               "@functools.cache\n"
               "def plan(shape):\n"
               "    return shape\n")
        assert _rules(lint_source(src)) == {"unbounded-cache"}

    def test_bare_lru_cache_is_flagged(self):
        src = ("import functools\n"
               "@functools.lru_cache\n"
               "def plan(shape):\n"
               "    return shape\n")
        assert _rules(lint_source(src)) == {"unbounded-cache"}

    def test_maxsize_none_is_flagged(self):
        src = ("import functools\n"
               "@functools.lru_cache(maxsize=None)\n"
               "def plan(shape):\n"
               "    return shape\n")
        assert _rules(lint_source(src)) == {"unbounded-cache"}

    def test_positional_none_is_flagged(self):
        src = ("from functools import lru_cache\n"
               "@lru_cache(None)\n"
               "def plan(shape):\n"
               "    return shape\n")
        assert _rules(lint_source(src)) == {"unbounded-cache"}

    def test_finite_maxsize_passes(self):
        src = ("import functools\n"
               "@functools.lru_cache(maxsize=64)\n"
               "def plan(shape):\n"
               "    return shape\n")
        assert lint_source(src) == []


# ---------------------------------------------------------------------------
# nameless-plan-error
# ---------------------------------------------------------------------------

class TestNamelessPlanError:

    def test_bare_constant_message_is_flagged(self):
        src = ("def plan(op):\n"
               "    raise PlanError('no feasible schedule')\n")
        assert _rules(lint_source(src)) == {"nameless-plan-error"}

    def test_missing_message_is_flagged(self):
        src = ("def plan(op):\n"
               "    raise execplan.PlanError()\n")
        assert _rules(lint_source(src)) == {"nameless-plan-error"}

    def test_formatted_message_passes(self):
        src = ("def plan(op):\n"
               "    raise PlanError(f'{op.name}: no feasible schedule')\n")
        assert lint_source(src) == []


# ---------------------------------------------------------------------------
# eager-compute-in-kernel (role: kernels)
# ---------------------------------------------------------------------------

LAUNCHER = ("from repro_torch.kernels.build import Kernel\n"
            "GEMM = Kernel('conv_im2col', 'matmul_bias_act_f32', [])\n")


class TestEagerCompute:

    def test_library_conv_is_flagged(self):
        src = ("import torch.nn.functional as F\n"
               "def forward(x, w):\n"
               "    return F.conv2d(x, w)\n")
        assert _rules(lint_source(src, roles={"kernels"})) \
            == {"eager-compute-in-kernel"}

    @pytest.mark.parametrize("call", [
        "torch.nn.functional.conv_transpose2d(x, w)", "torch.conv1d(x, w)"])
    def test_every_spelling_of_a_library_conv_is_flagged(self, call):
        src = f"import torch\ndef forward(x, w):\n    return {call}\n"
        assert _rules(lint_source(src, roles={"kernels"})) \
            == {"eager-compute-in-kernel"}

    def test_imported_library_conv_is_flagged(self):
        src = "from torch.nn.functional import conv2d\n"
        assert _rules(lint_source(src, roles={"kernels"})) \
            == {"eager-compute-in-kernel"}

    @pytest.mark.parametrize("expr", ["p @ w", "torch.matmul(p, w)",
                                      "torch.einsum('mk,kn->mn', p, w)",
                                      "F.linear(p, w.t())"])
    def test_library_compute_in_a_launcher_is_flagged(self, expr):
        src = LAUNCHER + (
            "def matmul(p, w, out):\n"
            f"    ref = {expr}\n"
            "    GEMM(p, w, out)\n"
            "    return out\n")
        assert _rules(lint_source(src, roles={"kernels"})) \
            == {"eager-compute-in-kernel"}

    def test_a_launch_through_a_local_alias_counts(self):
        src = LAUNCHER + (
            "K2 = GEMM\n"
            "def matmul(p, w, out, fast):\n"
            "    entry, args = (K2, [out]) if fast else (None, [])\n"
            "    entry, extra = K2, p @ w\n"
            "    entry(p, w, *args)\n")
        assert _rules(lint_source(src, roles={"kernels"})) \
            == {"eager-compute-in-kernel"}

    def test_plain_twin_beside_a_launcher_passes(self):
        src = LAUNCHER + (
            "def matmul_plain(p, w):\n"
            "    return p @ w\n"
            "def matmul(p, w, out):\n"
            "    if p.device.type == 'cpu':\n"
            "        return matmul_plain(p, w)\n"
            "    GEMM(p, w, out)\n"
            "    return out\n")
        assert lint_source(src, roles={"kernels"}) == []

    def test_rule_scoped_to_kernel_role(self):
        src = ("import torch.nn.functional as F\n"
               "def forward(x, w):\n"
               "    return F.conv2d(x, w)\n")
        assert lint_source(src, roles={"ops"}) == []


# ---------------------------------------------------------------------------
# unjitted-custom-vjp-wrapper (role: kernels): .apply, never .forward
# ---------------------------------------------------------------------------

class TestUnappliedAutogradFunction:

    CORE = ("import torch\n"
            "class _Core(torch.autograd.Function):\n"
            "    @staticmethod\n"
            "    def forward(ctx, x):\n"
            "        return x\n")

    def test_direct_forward_call_is_flagged(self):
        src = self.CORE + ("def apply(x):\n"
                           "    return _Core.forward(None, x)\n")
        assert _rules(lint_source(src, roles={"kernels"})) \
            == {"unjitted-custom-vjp-wrapper"}

    def test_wrapper_without_apply_is_flagged(self):
        src = self.CORE + ("def apply(x):\n"
                           "    fn = _Core\n"
                           "    return fn\n")
        assert _rules(lint_source(src, roles={"kernels"})) \
            == {"unjitted-custom-vjp-wrapper"}

    def test_applied_wrapper_passes(self):
        src = self.CORE + ("def apply(x):\n"
                           "    return _Core.apply(x)\n")
        assert lint_source(src, roles={"kernels"}) == []

    def test_private_helper_is_exempt(self):
        src = self.CORE + ("def _debug(x):\n"
                           "    return _Core.forward(None, x)\n")
        assert lint_source(src, roles={"kernels"}) == []


# ---------------------------------------------------------------------------
# unfaulted-wrapper (role: ops)
# ---------------------------------------------------------------------------

class TestUnfaultedWrapper:

    IMPORT = ("from repro_torch.kernels.conv_im2col import"
              " conv2d_im2col as _conv2d\n")

    def test_wrapper_without_fault_site_is_flagged(self):
        src = self.IMPORT + ("def conv2d(x, w, b):\n"
                             "    return _conv2d(x, w, b)\n")
        assert _rules(lint_source(src, roles={"ops"})) \
            == {"unfaulted-wrapper"}

    def test_wrapper_with_fault_site_passes(self):
        src = self.IMPORT + (
            "from repro_torch.core import faults\n"
            "def conv2d(x, w, b):\n"
            "    y = _conv2d(x, w, b)\n"
            "    if faults.enabled():\n"
            "        y = faults.corrupt_array(faults.SITE_CONV2D, y)\n"
            "    return y\n")
        assert lint_source(src, roles={"ops"}) == []

    def test_planning_helper_without_kernels_is_exempt(self):
        src = self.IMPORT + ("def shapes(cfg):\n"
                             "    return cfg.image_hw\n")
        assert lint_source(src, roles={"ops"}) == []

    def test_every_ops_wrapper_that_launches_is_reached(self):
        """The port's nine fault sites: each wrapper that calls a kernel
        alias is one the rule checks (so removing a site is caught)."""
        src = (ROOT / "src/repro_torch/kernels/ops.py").read_text()
        stripped = src.replace("out = faults.corrupt_array(",
                               "out = faults.corrupt(")
        flagged = {v.message.split()[0] for v in
                   lint_source(stripped, roles={"ops"})}
        assert flagged == {"conv2d", "votes_routing", "res_caps_segment",
                           "primary_routing", "caps_votes", "routing",
                           "squash", "rmsnorm", "flash_attention"}


# ---------------------------------------------------------------------------
# Drivers, and agreement with the reference's lint
# ---------------------------------------------------------------------------

class TestDrivers:

    def test_roles_for_paths(self):
        assert _roles_for("src/repro_torch/kernels/conv_im2col.py") \
            == frozenset({"kernels"})
        assert _roles_for("src/repro_torch/kernels/ops.py") \
            == frozenset({"kernels", "ops"})
        assert _roles_for("src/repro_torch/core/execplan.py") == frozenset()

    def test_repo_lints_clean(self):
        root = list(repro_torch.__path__)[0]
        assert lint_repo(root) == []


SHARED = ("unbounded-cache", "nameless-plan-error")
SEEDED = [
    "import functools\n@functools.cache\ndef f(x):\n    return x\n",
    "import functools\n@functools.lru_cache(maxsize=None)\ndef f(x):\n"
    "    return x\n",
    "from functools import lru_cache\n@lru_cache\ndef f(x):\n    return x\n",
    "def f(op):\n    raise PlanError('nothing fits')\n",
    "def f(op):\n    raise PlanError()\n",
    "def f(op):\n    raise PlanError(f'{op}: nothing fits')\n",
]
REAL = ["src/repro_torch/core/execplan.py", "src/repro_torch/kernels/ops.py",
        "src/repro_torch/kernels/votes_routing.py",
        "src/repro_torch/kernels/flash_attention.py",
        "src/repro/core/execplan.py", "src/repro/kernels/ops.py"]


def _shared(violations):
    return [(v.line, v.rule) for v in violations if v.rule in SHARED]


@pytest.mark.parametrize("source", SEEDED + REAL)
def test_shared_rules_agree_with_the_reference(source):
    text = (ROOT / source).read_text() if source in REAL else source
    ours = _shared(lint_source(text, roles=frozenset()))
    theirs = _shared(ref_lint_source(text, roles=frozenset()))
    assert ours == theirs
    if source in SEEDED[:5]:
        assert ours, "a seeded violation must be found"
