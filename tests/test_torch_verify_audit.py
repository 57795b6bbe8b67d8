"""The port's plan auditor (``repro_torch.verify.lowering``) and its CLI
on the CPU, after ``tests/test_verify_lowering.py``.

The facts come from the card (``derive_op``; ``tests/test_torch_gpu.py``
and ``chip_smoke.py`` run them there); here the pure comparison is held
to seeded facts -- every seeded lie must be caught and an honest op must
pass -- the shape check to plain CPU functions, the claims to the
reference's plans, and the CLI to its contract without a card.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs import registry as ref_registry
from repro.core import execplan as ref_execplan
from repro_torch.configs import registry
from repro_torch.core import execplan, planner
from repro_torch.kernels import build, ops  # noqa: F401  (fills REGISTRY)
from repro_torch.verify import __main__ as cli
from repro_torch.verify import lowering
from repro_torch.verify.lowering import (U_CLAIM, UHAT_CLAIM, KernelFacts,
                                         OpAudit, OpFacts, audit_op,
                                         claim_checks, compare,
                                         record_allocations)

ROOT = Path(__file__).resolve().parents[1]


def _checks_by_name(audit):
    return {c.name: c for c in audit.checks}


def _honest(op, **kw) -> OpFacts:
    """Facts of a run that does exactly what the plan op says."""
    facts = dict(kernels=(KernelFacts("entry", "kernel", 0, op.smem_bytes,
                                      1, op.cluster),),
                 passes=op.n_passes, w_blocks=2 if op.n_passes else None,
                 global_bytes=op.global_bytes)
    facts.update(kw)
    return OpFacts(**facts)


# ---------------------------------------------------------------------------
# Contracts: every kernel of every plan of the sweep has one
# ---------------------------------------------------------------------------

class TestContracts:

    @pytest.mark.parametrize("train", [False, True])
    @pytest.mark.parametrize("pipeline", [False, True])
    @pytest.mark.parametrize("arch", registry.CAPSNET_ARCHS)
    def test_every_planned_kernel_has_a_contract(self, arch, pipeline,
                                                 train):
        cfg = registry.get_config(arch)
        planned = 0
        for frac in cli.LADDER:
            try:
                plan, _ = execplan.degrade_plan(
                    cfg, int(planner.SMEM_BYTES * frac), batch=1,
                    train=train, pipeline=pipeline)
            except execplan.PlanError:
                # CIFAR-10's halves fit no reduced budget: a planner answer.
                assert arch == "capsnet-cifar10" and frac < 1
                continue
            for op in plan.ops:
                c = execplan.audit_contract(op)
                assert c.smem_rtol >= 0 and c.smem_over_factor >= 1
                assert c.global_rtol >= 0
                planned += 1
        assert planned

    def test_unknown_kernel_raises_a_named_plan_error(self):
        plan = execplan.compile_plan(registry.get_config("capsnet-mnist"))
        odd = dataclasses.replace(plan.ops[0], name="Mystery",
                                  kernel="mystery_kernel")
        with pytest.raises(execplan.PlanError, match="Mystery.*mystery"):
            execplan.audit_contract(odd)

    def test_keyed_by_the_reference_kernel_strings(self):
        assert set(execplan._AUDIT_CONTRACTS) == set(
            ref_execplan._AUDIT_CONTRACTS)


# ---------------------------------------------------------------------------
# Seeded drift: a wrong plan/kernel pair MUST be caught
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def svhn_plan():
    return execplan.compile_plan(registry.get_config("capsnet-svhn"),
                                 batch=4, pipeline=True, train=True)


@pytest.fixture(scope="module")
def svhn_routing_op(svhn_plan):
    # The pipelined op streams W iters + 1 times: every lie is visible.
    op = svhn_plan.op(execplan.PIPE_NAME)
    assert op.n_passes and op.n_passes > 1
    return op


class TestSeededDrift:

    def test_understated_smem_is_caught(self, svhn_plan, svhn_routing_op):
        lie = dataclasses.replace(svhn_routing_op,
                                  smem_bytes=svhn_routing_op.smem_bytes // 2)
        audit = audit_op(svhn_plan, lie, facts=_honest(svhn_routing_op))
        assert not audit.ok
        assert not _checks_by_name(audit)["smem-under-model"].ok

    def test_overstated_smem_is_caught(self, svhn_plan, svhn_routing_op):
        lie = dataclasses.replace(svhn_routing_op,
                                  smem_bytes=svhn_routing_op.smem_bytes * 4)
        audit = audit_op(svhn_plan, lie, facts=_honest(svhn_routing_op))
        assert not _checks_by_name(audit)["smem-over-model"].ok

    def test_wrong_traffic_is_caught(self, svhn_plan, svhn_routing_op):
        lie = dataclasses.replace(
            svhn_routing_op, global_bytes=svhn_routing_op.global_bytes * 10)
        audit = audit_op(svhn_plan, lie, facts=_honest(svhn_routing_op))
        assert not _checks_by_name(audit)["global-traffic"].ok

    def test_wrong_pass_count_is_caught(self, svhn_plan, svhn_routing_op):
        lie = dataclasses.replace(svhn_routing_op,
                                  n_passes=svhn_routing_op.n_passes + 3)
        audit = audit_op(svhn_plan, lie, facts=_honest(svhn_routing_op))
        assert not _checks_by_name(audit)["w-pass-count"].ok

    def test_honest_op_passes_the_same_checks(self, svhn_plan,
                                              svhn_routing_op):
        audit = audit_op(svhn_plan, svhn_routing_op,
                         facts=_honest(svhn_routing_op))
        assert audit.ok and not audit.unverified(), [
            f"{c.name}: {c.detail}" for c in audit.failures()]
        assert {c.name for c in audit.checks} == {
            "smem-under-model", "smem-over-model", "fits-the-card",
            "w-pass-count", "global-traffic", UHAT_CLAIM}

    def test_unread_counters_are_unverified_never_ok(self, svhn_plan,
                                                     svhn_routing_op):
        facts = _honest(svhn_routing_op, global_bytes=None,
                        counter_note="ERR_NVGPUCTRPERM")
        audit = audit_op(svhn_plan, svhn_routing_op, facts=facts)
        traffic = _checks_by_name(audit)["global-traffic"]
        assert traffic.unverified and not traffic.ok and not traffic.drift
        assert "ERR_NVGPUCTRPERM" in traffic.detail
        assert audit.ok and audit.unverified() == [traffic]

    def test_a_footprint_over_the_budget_is_caught(self, svhn_plan,
                                                   svhn_routing_op):
        big = svhn_plan.smem_budget + 1024
        lie = dataclasses.replace(svhn_routing_op, smem_bytes=big)
        facts = _honest(lie)
        assert not _checks_by_name(audit_op(
            svhn_plan, lie, facts=facts))["fits-the-card"].ok

    @pytest.mark.parametrize("kernel", [
        KernelFacts("entry", "K5", 0, 100, 0, None),      # none co-resident
        KernelFacts("entry", "K5", 0, 100, 3, 2)])        # another cluster
    def test_a_launch_the_card_cannot_hold_as_planned_is_caught(
            self, svhn_plan, svhn_routing_op, kernel):
        kernel = dataclasses.replace(
            kernel, dynamic_smem=svhn_routing_op.smem_bytes,
            cluster=kernel.cluster and svhn_routing_op.cluster * 2)
        facts = _honest(svhn_routing_op, kernels=(kernel,))
        audit = audit_op(svhn_plan, svhn_routing_op, facts=facts)
        assert not _checks_by_name(audit)["fits-the-card"].ok

    def test_a_single_i_block_crosses_device_memory_once(self, svhn_plan,
                                                         svhn_routing_op):
        facts = _honest(svhn_routing_op, passes=7, w_blocks=1)
        check = _checks_by_name(audit_op(svhn_plan, svhn_routing_op,
                                         facts=facts))["w-pass-count"]
        assert check.ok and "single i-block" in check.detail

    def test_a_resident_op_that_claims_more_passes_is_caught(self,
                                                             svhn_plan):
        op = svhn_plan.op(execplan.FUSED_NAME)
        assert op.mode == "resident" and op.n_passes == 1
        lie = dataclasses.replace(op, n_passes=4)
        facts = _honest(op, w_blocks=1)
        assert not _checks_by_name(audit_op(svhn_plan, lie, facts=facts))[
            "w-pass-count"].ok

    def test_the_backward_check_names_the_ports_count(self, svhn_plan):
        op = svhn_plan.op(execplan.FUSED_NAME + "[0]" + execplan.BWD_SUFFIX)
        assert op.mode == "streamed" and op.n_passes == 3 + 2
        check = _checks_by_name(audit_op(svhn_plan, op, facts=_honest(op)))[
            "w-pass-count"]
        assert check.ok and "iters + 2" in check.detail

    def test_a_run_that_launched_nothing_raises(self, svhn_plan,
                                                svhn_routing_op):
        with pytest.raises(lowering.AuditError, match="launched no kernel"):
            compare(svhn_plan, svhn_routing_op, OpFacts(kernels=()))

    def test_the_peak_is_the_largest_kernel_of_the_op(self, svhn_plan):
        op = svhn_plan.op("PrimaryCaps-bwd")
        small = KernelFacts("matmul_at_b_f32", "at_b", 0, 1024, 2)
        peak = KernelFacts("matmul_bias_act_f32", "gemm", 0, op.smem_bytes, 1)
        audit = audit_op(svhn_plan, op, facts=_honest(
            op, kernels=(small, peak)))
        assert audit.ok
        audit = audit_op(svhn_plan, op, facts=_honest(op, kernels=(small,)))
        assert not _checks_by_name(audit)["smem-over-model"].ok


# ---------------------------------------------------------------------------
# The zero-intermediate check: the shapes a run allocated
# ---------------------------------------------------------------------------

class TestShapeCheck:

    B, I, C, J = 2, 8, 4, 6

    def _inputs(self):
        g = torch.Generator().manual_seed(0)
        return (torch.randn(self.B, self.I, self.C, generator=g),
                torch.randn(self.I, self.C, self.J, generator=g))

    def test_materialized_uhat_fails_the_claim(self):
        u, w = self._inputs()
        with record_allocations() as shapes:
            uhat = (u[..., None] * w[None]).sum(2)      # (B, I, J)
            uhat.sum()
        chk = lowering._shape_check(shapes, {(self.B, self.I, self.J)}, set(),
                                    UHAT_CLAIM)
        assert not chk.ok
        assert str((self.B, self.I, self.J)) in chk.detail

    def test_clean_function_passes_the_claim(self):
        u, w = self._inputs()
        with record_allocations() as shapes:
            torch.einsum("bic,icj->bj", u, w)            # (B, J) only
        chk = lowering._shape_check(shapes, {(self.B, self.I, self.J)}, set(),
                                    UHAT_CLAIM)
        assert chk.ok

    def test_allowed_shapes_are_exempt(self):
        u, w = self._inputs()
        with record_allocations() as shapes:
            (u[..., None] * w[None]).sum(2)
        forbidden = {(self.B, self.I, self.J)}
        assert lowering._shape_check(shapes, forbidden, forbidden,
                                     UHAT_CLAIM).ok

    def test_views_and_in_place_results_own_no_memory(self):
        x = torch.zeros(self.B, self.I, self.J)
        flat = torch.zeros(self.B * self.I * self.J)
        with record_allocations() as shapes:
            flat.view(self.B, self.I, self.J)
            x.transpose(0, 1).transpose(0, 1)
            x.add_(1.0)
        assert shapes == []

    def test_a_batched_product_of_the_votes_is_caught(self):
        """The split path's K14a writes [B, I, J*D]; an einsum on the host
        lays the same votes out [I, B, J*D]: both break the claim."""
        cfg = registry.get_smoke_config("capsnet-mnist")
        plan = execplan.compile_plan(cfg, batch=2)
        op = plan.op(execplan.FUSED_NAME)
        lay = cfg.routing_stack()[-1]
        u = torch.randn(2, lay.in_caps, lay.in_dim)
        w = torch.randn(lay.in_caps, lay.jd, lay.in_dim)
        for leak in (lambda: torch.einsum("bic,inc->bin", u, w),
                     lambda: torch.empty(2, lay.in_caps, lay.jd)):
            with record_allocations() as shapes:
                leak()
            (chk,) = claim_checks(plan, op, shapes)
            assert chk.name == UHAT_CLAIM and not chk.ok
        with record_allocations() as shapes:
            torch.empty(2, lay.in_caps, lay.in_dim)        # u: allowed
        assert all(c.ok for c in claim_checks(plan, op, shapes))


# ---------------------------------------------------------------------------
# The claims are the reference's own
# ---------------------------------------------------------------------------

def _claims(plan):
    return {op.name: sorted(lowering.zero_intermediate_claims(plan, op))
            for op in plan.ops}


def _ref_claims(plan):
    return {op.name: sorted(
        ([UHAT_CLAIM] if op.uhat_hbm_bytes == 0.0 else [])
        + ([U_CLAIM] if op.intermediate_hbm_bytes == 0.0 else []))
        for op in plan.ops}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("pipeline", [False, True])
@pytest.mark.parametrize("arch,batch", [
    ("capsnet-mnist", 1), ("capsnet-mnist", 8), ("capsnet-svhn", 1),
    ("capsnet-svhn", 8), ("capsnet-cifar10", 1)])
def test_claim_ops_are_the_references_own(arch, batch, pipeline, train):
    ours = _claims(execplan.compile_plan(registry.get_config(arch),
                                         batch=batch, pipeline=pipeline,
                                         train=train))
    theirs = _ref_claims(ref_execplan.compile_plan(
        ref_registry.get_config(arch), batch=batch, pipeline=pipeline,
        train=train))
    common = ours.keys() & theirs.keys()
    assert any(ours[n] for n in common)
    assert {n: ours[n] for n in common} == {n: theirs[n] for n in common}


def test_mnist_claims_at_batch_one():
    cfg = registry.get_config("capsnet-mnist")
    per_op = _claims(execplan.compile_plan(cfg, train=True))
    piped = _claims(execplan.compile_plan(cfg, train=True, pipeline=True))
    assert {n for n, c in per_op.items() if c} == {
        "ClassCaps-Routing", "ClassCaps-Routing-bwd"}
    assert {n: c for n, c in piped.items() if c} == {
        execplan.PIPE_NAME: sorted([UHAT_CLAIM, U_CLAIM]),
        "ClassCaps-Routing-bwd": [UHAT_CLAIM]}


# ---------------------------------------------------------------------------
# The CLI, the card-side entry points and the sweep's report on the CPU
# ---------------------------------------------------------------------------

def test_lint_only_exits_zero(capsys):
    assert cli.main(["--lint-only"]) == 0
    assert "lint: 0 violation(s)" in capsys.readouterr().out


def _run_cli(*args):
    return subprocess.run([sys.executable, "-m", "repro_torch.verify", *args],
                          capture_output=True, text=True, cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"}, timeout=300)


def test_the_module_entry_point_lints_and_refuses_to_audit_without_a_card():
    assert not torch.cuda.is_available()
    lint = _run_cli("--lint-only")
    assert lint.returncode == 0, lint.stderr
    audit = _run_cli("--arch", "capsnet-mnist", "--no-ladder")
    assert audit.returncode != 0
    assert "device='cpu'" in audit.stderr


def test_the_audit_raises_the_device_error_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    plan = execplan.compile_plan(registry.get_smoke_config("capsnet-mnist"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lowering.derive_op(plan, plan.ops[0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--arch", "capsnet-mnist", "--no-ladder", "--audit-only"])


def test_every_launch_the_auditor_reads_matches_its_kernel_binding():
    """The auditor names each C entry's arguments; the names must be as
    many as the entry's bound argument types."""
    assert set(lowering._ARGS) <= set(build.REGISTRY)
    for entry, names in lowering._ARGS.items():
        assert len(names.split()) == len(build.REGISTRY[entry].argtypes), \
            entry


def test_the_report_counts_unverified_checks_apart(svhn_plan,
                                                   svhn_routing_op, capsys):
    facts = _honest(svhn_routing_op, global_bytes=None,
                    counter_note="no counters")
    audit = audit_op(svhn_plan, svhn_routing_op, facts=facts)
    result = cli.Sweep(cells=2, infeasible=1, audits=[audit])
    cli.report(result)
    out = capsys.readouterr().out
    assert "2 plan cells swept (1 with no feasible plan), 0 drift(s), " \
           "1 unverified check(s)" in out
    assert "UNVERIFIED 1 x [global-traffic] not measured: no counters" in out
    assert "margins primary_routing" in out


def test_margins_are_the_worst_over_the_audits(svhn_plan, svhn_routing_op):
    op = svhn_routing_op
    big = _honest(op, kernels=(KernelFacts("e", "k", 100, op.smem_bytes, 1,
                                           op.cluster),))
    small = _honest(op, kernels=(KernelFacts("e", "k", 0, op.smem_bytes // 2,
                                             1, op.cluster),),
                    global_bytes=op.global_bytes * 1.25)
    audits = [OpAudit(op.name, op.kernel, f, (), op) for f in (big, small)]
    row = lowering.margins(audits)["primary_routing"]
    assert row["smem_rtol"] == pytest.approx(100 / op.smem_bytes)
    assert row["smem_over_factor"] == pytest.approx(
        op.smem_bytes / (op.smem_bytes // 2))
    assert row["global_rtol"] == pytest.approx(0.25)


@pytest.mark.parametrize("arch", registry.CAPSNET_ARCHS)
def test_every_op_runner_runs_its_call_on_the_cpu(arch):
    """What the auditor runs on the card for each op of the sweep, here at
    the smoke config on the CPU (the kernels' twins): every op of every
    (pipeline, train, rung) plan has a runner whose call goes through."""
    cfg = registry.get_smoke_config(arch)
    ran = 0
    for pipeline in (False, True):
        for train in (False, True):
            for frac in cli.LADDER:
                plan, _ = execplan.degrade_plan(
                    cfg, int(planner.SMEM_BYTES * frac), batch=2,
                    train=train, pipeline=pipeline)
                for op in plan.ops:
                    gen = torch.Generator().manual_seed(0)
                    lowering._runner(plan, op, torch.device("cpu"), gen)()
                    ran += 1
    assert ran >= 4 * len(cli.LADDER) * 3     # >= 3 ops a plan
