"""``python -m repro_torch.verify`` -- the plan audit and the contract lint.

Sweeps every registered CapsuleNet arch across {per-op, pipelined} x
{forward, train} x a ladder of shared-memory budgets, runs each
``OpPlan``'s kernels once on the card and holds what the built kernels
and the card report -- shared memory a CTA, whether it fits, the votes
passes, the L2 traffic, the zero-intermediate claims -- to the plan's
modeled contracts (``verify.lowering``); then runs the AST contract lint
over ``src/repro_torch`` (``verify.lint``).  Exits nonzero on any drift
or lint violation.  A check the card cannot measure is ``unverified``:
counted and printed beside the drifts, never passed as ok.

``--lint-only`` needs no card.  The audit needs one, and without it
raises the port's device error and exits nonzero; it is never skipped.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import sys
from collections import Counter

from repro_torch.configs import registry
from repro_torch.core import execplan, planner
from repro_torch.verify.lint import lint_repo
from repro_torch.verify.lowering import audit_plan, margins

# The budget rungs of each (arch, pipeline, train) cell, as shares of
# ``planner.SMEM_BYTES``: the full budget, then the serving engine's
# replan ladder.
LADDER = (1.0, 0.5, 0.25)


def _parse(argv):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.verify",
        description="Hold the plans' modeled shared memory, traffic and "
                    "passes to the built kernels on the card, and lint "
                    "the port's contracts.")
    ap.add_argument("--arch", action="append",
                    help="CapsNet arch id (repeatable; default: all "
                         f"of {registry.CAPSNET_ARCHS})")
    ap.add_argument("--batch", type=int, default=1,
                    help="plan batch size (default 1)")
    ap.add_argument("--shards", type=int, default=1,
                    help="audit the per-shard plan of a batch split over "
                         "N engine shards (default 1)")
    ap.add_argument("--train", action="store_true",
                    help="audit ONLY train plans (default: fwd and train)")
    ap.add_argument("--pipeline", action="store_true",
                    help="audit ONLY pipelined plans (default: both)")
    ap.add_argument("--no-ladder", action="store_true",
                    help="skip the degraded-budget rungs")
    ap.add_argument("--lint-only", action="store_true")
    ap.add_argument("--audit-only", action="store_true")
    ap.add_argument("--lint-root", default=None,
                    help="directory to lint (default: the repro_torch "
                         "package source)")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="print failures only")
    return ap.parse_args(argv)


@dataclasses.dataclass
class Sweep:
    """What a sweep found: its cells, those with no feasible plan, each
    drift as a printed line, and the op audits."""

    cells: int = 0
    infeasible: int = 0
    drifts: list[str] = dataclasses.field(default_factory=list)
    audits: list = dataclasses.field(default_factory=list)

    @property
    def unverified(self) -> int:
        return sum(len(audit.unverified()) for audit in self.audits)

    def reasons(self) -> Counter:
        """The unverified checks counted by check and what it reports."""
        return Counter(f"[{c.name}] {c.detail}" for audit in self.audits
                       for c in audit.unverified())


def sweep(archs, *, batch: int, trains=(False, True), pipes=(False, True),
          rungs=LADDER, quiet: bool = False, counters: bool = True,
          cache: dict | None = None, result: Sweep | None = None) -> Sweep:
    """Audit every (arch, pipeline, train, budget rung) cell at ``batch``;
    the facts of an op met twice are derived once (``cache``)."""
    result = result if result is not None else Sweep()
    cache = {} if cache is None else cache
    for arch in archs:
        cfg = registry.get_config(registry.canonical(arch))
        for pipeline in pipes:
            for train in trains:
                for frac in rungs:
                    result.cells += 1
                    label = (f"{arch} batch={batch} pipe={pipeline} "
                             f"train={train} budget={frac:.0%}")
                    try:
                        plan, report = execplan.degrade_plan(
                            cfg, int(planner.SMEM_BYTES * frac),
                            batch=batch, train=train, pipeline=pipeline)
                    except execplan.PlanError as err:
                        # An infeasible rung is a planner answer, not drift.
                        result.infeasible += 1
                        if not quiet:
                            print(f"  [{label}] no feasible plan: {err}")
                        continue
                    if report.degraded and not quiet:
                        print(f"  [{label}] concessions: "
                              f"{'; '.join(report.concessions)}")
                    audit = audit_plan(plan, label=label, counters=counters,
                                       cache=cache)
                    for op_audit in audit.ops:
                        result.audits.append(op_audit)
                        for check in op_audit.checks:
                            line = (f"{label} {op_audit.op} [{check.name}] "
                                    f"{check.detail}")
                            if check.drift:
                                result.drifts.append(line)
                                print(f"DRIFT {line}")
                            elif not quiet and not check.unverified:
                                print(f"  ok {label} {op_audit.op} "
                                      f"[{check.name}]")
    return result


def report(result: Sweep) -> None:
    """The sweep's summary: cells, drifts, unverified checks with their
    reasons, and the worst margins by kernel (what the contracts are
    calibrated to)."""
    print(f"audit: {result.cells} plan cells swept "
          f"({result.infeasible} with no feasible plan), "
          f"{len(result.drifts)} drift(s), {result.unverified} "
          f"unverified check(s)")
    for reason, n in sorted(result.reasons().items()):
        print(f"UNVERIFIED {n} x {reason}")
    for kernel, row in sorted(margins(result.audits).items()):
        print(f"margins {kernel}: smem over the model by "
              f"{row['smem_rtol']:.4f} at most, the model x"
              f"{row['smem_over_factor']:.4f} the kernels at most, "
              f"traffic off by {row['global_rtol']:.4f} at most")


def main(argv=None) -> int:
    args = _parse(argv if argv is not None else sys.argv[1:])
    failures = 0

    if not args.lint_only:
        archs = args.arch or registry.CAPSNET_ARCHS
        result = sweep(
            archs, batch=max(1, math.ceil(args.batch / max(args.shards, 1))),
            trains=(True,) if args.train else (False, True),
            pipes=(True,) if args.pipeline else (False, True),
            rungs=(1.0,) if args.no_ladder else LADDER, quiet=args.quiet)
        report(result)
        failures += len(result.drifts)

    if not args.audit_only:
        root = args.lint_root
        if root is None:
            import repro_torch
            root = repro_torch.__path__[0]
        violations = lint_repo(root)
        for v in violations:
            print(f"LINT {v}")
        failures += len(violations)
        print(f"lint: {len(violations)} violation(s) under {root}")

    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
