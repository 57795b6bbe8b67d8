"""Verification of the port's modeled contracts.

* ``verify.lowering`` -- the plan auditor: runs every ``OpPlan``'s
  kernels once on the card and holds what the built kernels and the card
  report (shared memory a CTA from ``cudaFuncGetAttributes`` and the
  launch, whether the card holds it, the votes passes the kernels count,
  the L2 traffic from the card's counters, the tensors that reach device
  memory) to the numbers ``core.execplan`` modeled, within
  ``execplan.audit_contract``.
* ``verify.lint`` -- AST contract lint over ``src/repro_torch``: fault
  sites on every public kernel wrapper, bounded ``lru_cache``s, autograd
  Functions called through ``.apply``, no library compute where a kernel
  launches, formatted ``PlanError``s.

``verify.invariants`` holds the counter checks of ``CapsuleEngine.stats()``
that the serving tests and ``chip_smoke.py`` share.  CLI: ``python -m
repro_torch.verify``.
"""

from repro_torch.verify.invariants import (assert_engine_stats,  # noqa: F401
                                           check_engine_stats)
from repro_torch.verify.lint import (LintViolation, lint_paths,  # noqa: F401
                                     lint_repo, lint_source)
from repro_torch.verify.lowering import (Check, OpAudit,  # noqa: F401
                                         PlanAudit, audit_config, audit_op,
                                         audit_plan)

__all__ = [
    "audit_config", "audit_op", "audit_plan",
    "Check", "OpAudit", "PlanAudit",
    "lint_source", "lint_paths", "lint_repo", "LintViolation",
    "check_engine_stats", "assert_engine_stats",
]
