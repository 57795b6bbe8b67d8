"""CapStore's own models on the port: the dataflow analysis, the SRAM
energy model, the sector power-gating PMU and the memory-organisation DSE
(``repro_torch.core.{analysis,energy,pmu,dse}``), and the plan accounting
they read (``ExecutionPlan.profiles``, ``phase_requirements``,
``phase_groups``, ``phase_durations``, ``forward_hbm_bytes``).

The four models are the reference's, so they are held to it exactly: the
same profiles, energy terms, PMU schedules and DSE results on the paper's
MNIST dims under both dataflows, and the paper's claims that
``tests/test_capstore.py`` checks.  The port's plans cover the same
dataflow operations with the same phases wherever the reference plans
(CIFAR-10 training at batch 1 only); a phase's demand and duration equal
the reference's where the two plans agree on the op's mode and pass
count, and follow the port's stated formula where they differ
(``streamed-global``; the backward's pass count).
"""

import dataclasses
import runpy
import types
from pathlib import Path

import pytest

from repro.configs import registry as ref_registry
from repro.core import analysis as ref_analysis
from repro.core import dse as ref_dse
from repro.core import energy as ref_energy
from repro.core import execplan as ref_execplan
from repro.core import pmu as ref_pmu
from repro_torch.configs import registry
from repro_torch.core import analysis, dse, energy, execplan, pmu
from repro_torch.core.execplan import BWD_SUFFIX, STREAMED_GLOBAL

DATAFLOWS = ("resident", "linebuf")
ARCHS = ("capsnet-mnist", "capsnet-svhn", "capsnet-cifar10")
# (arch, batch, pipeline, train) wherever the reference plans: every arch
# at batch 1, MNIST and SVHN at batch 8 (the reference's CIFAR-10 plans
# fit its VMEM at batch 1 only).
PLAN_CASES = [(a, b, p, t) for a in ARCHS for b in (1, 8)
              for p in (False, True) for t in (False, True)
              if b == 1 or a != "capsnet-cifar10"]


def _t(x):
    """A dataclass (or a sequence of them) as plain tuples, so the
    port's and the reference's classes compare by value."""
    if isinstance(x, (list, tuple)):
        return [dataclasses.astuple(v) for v in x]
    return dataclasses.astuple(x)


def _plans(arch, batch, pipeline, train, dataflow="resident"):
    kw = dict(batch=batch, pipeline=pipeline, train=train,
              dataflow=dataflow)
    return (ref_execplan.compile_plan(ref_registry.get_config(arch), **kw),
            execplan.compile_plan(registry.get_config(arch), **kw))


# ---------------------------------------------------------------------------
# The models equal the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dataflow", DATAFLOWS)
def test_profiles_equal_the_reference(dataflow):
    assert _t(analysis.capsnet_profiles(dataflow)) == _t(
        ref_analysis.capsnet_profiles(dataflow))
    for arch in ARCHS:
        cfg, rcfg = registry.get_config(arch), ref_registry.get_config(arch)
        dims = analysis.dims_from_config(cfg)
        assert _t(dims) == _t(ref_analysis.dims_from_config(rcfg))
        layers = execplan._layer_descs(cfg.routing_stack())
        assert layers == ref_execplan._layer_descs(rcfg.routing_stack())
        assert _t(analysis.capsnet_stack_profiles(dataflow, dims, layers)) \
            == _t(ref_analysis.capsnet_stack_profiles(
                dataflow, ref_analysis.dims_from_config(rcfg), layers))
    profs = analysis.capsnet_profiles(dataflow)
    refp = ref_analysis.capsnet_profiles(dataflow)
    for fn in ("peak_total_mem", "total_cycles", "total_macs",
               "total_offchip_accesses"):
        assert getattr(analysis, fn)(profs) == getattr(ref_analysis, fn)(refp)
    for comp in analysis.COMPONENTS:
        assert analysis.peak_component_mem(profs, comp) \
            == ref_analysis.peak_component_mem(refp, comp)
        assert analysis.min_component_mem(profs, comp) \
            == ref_analysis.min_component_mem(refp, comp)


def test_unknown_dataflow_rejected():
    with pytest.raises(ValueError):
        analysis.capsnet_profiles("bogus")
    with pytest.raises(ValueError):
        execplan.compile_plan(registry.get_config("capsnet-mnist"),
                              dataflow="bogus")


@pytest.mark.parametrize("ports", [1, 2, 3])
@pytest.mark.parametrize("gated", [False, True])
def test_energy_terms_equal_the_reference(ports, gated):
    for cap in (0, 1024, 96 * 1024, 2 ** 21, 8 * 2 ** 20):
        for banks, sectors in ((1, 1), (8, 4), (16, 128)):
            mine = energy.SRAMConfig("m", cap, ports=ports, banks=banks,
                                     sectors_per_bank=sectors,
                                     power_gated=gated)
            ref = ref_energy.SRAMConfig("m", cap, ports=ports, banks=banks,
                                        sectors_per_bank=sectors,
                                        power_gated=gated)
            for write in (False, True):
                assert mine.access_energy_pj(write) \
                    == ref.access_energy_pj(write)
            for frac in (0.0, 0.013, 0.5, 1.0):
                assert mine.leakage_mw(frac) == ref.leakage_mw(frac)
                assert mine.quantize_on_fraction(frac) \
                    == ref.quantize_on_fraction(frac)
            for woken in (0, 1, 7):
                assert mine.wakeup_energy_pj(woken) \
                    == ref.wakeup_energy_pj(woken)
                assert mine.wakeup_latency_cycles(woken) \
                    == ref.wakeup_latency_cycles(woken)
            assert mine.area_mm2() == ref.area_mm2()
    for fn, arg in (("dram_energy_pj", 1e6), ("dram_static_mj", 1e-3),
                    ("accelerator_dynamic_mj", 3e8),
                    ("accelerator_static_mj", 1e-3),
                    ("buffer_energy_mj", 5e6), ("pj_to_mj", 42.0),
                    ("cycles_to_s", 1e6)):
        assert getattr(energy, fn)(arg) == getattr(ref_energy, fn)(arg)


def test_pmu_schedules_equal_the_reference():
    phases = [("a", 4096, 1000), ("b", 16384, 3000), ("c", 0, 50),
              ("d", 9000, 70)]
    for gated in (False, True):
        for sectors in (1, 8, 128):
            kw = dict(capacity_bytes=16384, banks=16,
                      sectors_per_bank=sectors, power_gated=gated)
            mine = pmu.build_schedule(
                energy.SRAMConfig("m", **kw),
                [pmu.PhaseRequirement(*p) for p in phases])
            ref = ref_pmu.build_schedule(
                ref_energy.SRAMConfig("m", **kw),
                [ref_pmu.PhaseRequirement(*p) for p in phases])
            assert _t(mine) == _t(ref)
            assert (mine.static_mj, mine.wakeup_mj,
                    mine.total_transitions) == (ref.static_mj, ref.wakeup_mj,
                                                ref.total_transitions)


def _ev(ev):
    return (ev.org.name, ev.total_mj, ev.dynamic_mj, ev.static_mj,
            ev.wakeup_mj, ev.area_mm2, ev.wakeup_latency_cycles,
            ev.per_op_mj, [_t(s) for s in ev.per_sram])


@pytest.mark.parametrize("dataflow", DATAFLOWS)
def test_dse_equals_the_reference(dataflow):
    profs = analysis.capsnet_profiles(dataflow)
    refp = ref_analysis.capsnet_profiles(dataflow)
    for sectors in (1, 64, 128):
        orgs = dse.design_organizations(profs, sectors=sectors)
        rorgs = ref_dse.design_organizations(refp, sectors=sectors)
        assert list(orgs) == list(rorgs)
        for name, org in orgs.items():
            assert _t(org) == _t(rorgs[name])
            assert _ev(dse.evaluate(org, profs)) \
                == _ev(ref_dse.evaluate(rorgs[name], refp))
    mine, ref = dse.explore(profs), ref_dse.explore(refp)
    assert [(r.org_name, r.sectors, r.total_mj, r.area_mm2) for r in mine] \
        == [(r.org_name, r.sectors, r.total_mj, r.area_mm2) for r in ref]
    best = dse.best_design(profs)
    for mine_s, ref_s in (
            (dse.all_onchip_system(profs), ref_dse.all_onchip_system(refp)),
            (dse.hierarchy_system(profs, best.evaluation),
             ref_dse.hierarchy_system(refp,
                                      ref_dse.best_design(refp).evaluation))):
        assert _t(mine_s) == _t(ref_s)


@pytest.mark.parametrize("train", [False, True])
def test_default_plan_exploration_equals_the_reference(train):
    """``explore(train=...)`` scores the default MNIST plan at batch 1,
    whose every op has the reference's mode and pass count there."""
    mine, ref = dse.explore(train=train), ref_dse.explore(train=train)
    assert [(r.org_name, r.sectors, r.total_mj) for r in mine] \
        == [(r.org_name, r.sectors, r.total_mj) for r in ref]
    with pytest.raises(ValueError):
        dse.explore(analysis.capsnet_profiles(),
                    plan=execplan.compile_plan())


# ---------------------------------------------------------------------------
# The paper's claims hold on the port (tests/test_capstore.py)
# ---------------------------------------------------------------------------

PROFILES = analysis.capsnet_profiles()
ORGS = dse.design_organizations(PROFILES)
EVALS = {n: dse.evaluate(o, PROFILES) for n, o in ORGS.items()}


@pytest.mark.parametrize("dataflow", DATAFLOWS)
def test_pg_sep_is_best_design(dataflow):
    assert dse.best_design(
        analysis.capsnet_profiles(dataflow)).org_name == "PG-SEP"


def test_hierarchy_beats_all_onchip():
    a = dse.all_onchip_system(PROFILES)
    b = dse.hierarchy_system(PROFILES, EVALS["SMP"])
    assert 0.45 < 1 - b.total_mj / a.total_mj < 0.80       # paper: 66%
    best = dse.best_design(PROFILES)
    c = dse.hierarchy_system(PROFILES, best.evaluation)
    assert 1 - c.total_mj / a.total_mj > 0.7                # paper: 78%


def test_pg_never_raises_leakage():
    for frac in (0.0, 0.25, 0.5, 0.99, 1.0):
        for sectors in (1, 4, 128):
            for cap in (1024, 2 ** 20):
                gated = energy.SRAMConfig("g", cap, power_gated=True,
                                          sectors_per_bank=sectors)
                flat = energy.SRAMConfig("f", cap)
                assert gated.leakage_mw(gated.quantize_on_fraction(frac)) \
                    <= flat.leakage_mw() + 1e-12
    for base in ("SMP", "SEP", "HY"):
        assert EVALS[f"PG-{base}"].static_mj <= EVALS[base].static_mj


def test_wakeup_overhead_negligible_and_hy_between():
    for ev in EVALS.values():
        assert ev.wakeup_mj < 0.01 * max(ev.total_mj, 1e-12)
    assert EVALS["SEP"].total_mj < EVALS["HY"].total_mj \
        < EVALS["SMP"].total_mj


# ---------------------------------------------------------------------------
# The port's plans: phases, profiles, requirements
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,batch,pipeline,train", PLAN_CASES)
def test_plan_phases_and_profiles_equal_the_reference(arch, batch, pipeline,
                                                      train):
    ref, mine = _plans(arch, batch, pipeline, train)
    assert mine.phase_groups() == ref.phase_groups()
    assert _t(mine.profiles) == _t(ref.profiles)
    assert mine.dataflow == ref.dataflow == "resident"
    mine.validate()


@pytest.mark.parametrize("arch", ARCHS)
def test_linebuf_plans_cover_the_linebuf_profiles(arch):
    ref, mine = _plans(arch, 1, True, True, "linebuf")
    assert _t(mine.profiles) == _t(ref.profiles)
    assert mine.phase_groups() == ref.phase_groups()
    assert mine is not execplan.compile_plan(registry.get_config(arch),
                                             pipeline=True, train=True)


def _stated(ref_plan, mine, op):
    """The reference's builder fed ``op``'s mode and pass count as the
    port states them: streamed-global is streamed less the logits, and a
    backward's votes recomputations are its ``n_passes`` (the reference
    divides its W streams by 2)."""
    cfg = mine.cfg
    profs = ref_plan.op(op.name).profiles
    if op.kernel == "votes_routing_bwd":
        lay = execplan._layer_of(cfg, op.name[:-len(BWD_SUFFIX)])
        sched = types.SimpleNamespace(
            mode="streamed" if op.mode == STREAMED_GLOBAL else op.mode,
            n_passes=2 * op.n_passes)
        req = ref_execplan._fused_bwd_requirement(
            lay.in_caps, lay.num_caps, lay.jd, lay.iters, profs, sched,
            name=lay.name)
        drop = (lay.iters + 1) * lay.in_caps * lay.num_caps
    elif op.kernel in ("votes_routing", "primary_routing"):
        lay = (cfg.routing_stack()[0] if op.kernel == "primary_routing"
               else execplan._layer_of(cfg, op.name))
        sched = types.SimpleNamespace(
            mode="streamed" if op.mode == STREAMED_GLOBAL else op.mode,
            n_passes=op.n_passes)
        build = (ref_execplan._pipe_requirement
                 if op.kernel == "primary_routing"
                 else ref_execplan._fused_requirement)
        args = (lay.in_caps, lay.num_caps, lay.jd, profs, sched)
        req = build(*args) if op.kernel == "primary_routing" else build(
            *args, name=op.name)
        drop = lay.in_caps * lay.num_caps
    else:
        return _t(ref_plan.op(op.name).requirement)
    gone = drop * analysis.ACC_BYTES if op.mode == STREAMED_GLOBAL else 0
    return (req.name, req.required_bytes - gone, req.duration_cycles)


@pytest.mark.parametrize("arch,batch,pipeline,train", PLAN_CASES)
def test_phase_requirements_follow_the_reference(arch, batch, pipeline,
                                                 train):
    """Each phase equals the reference's where the two plans agree on the
    op's mode and pass count (the backward's counts compared as the
    reference's over 2), and the stated formula everywhere."""
    ref, mine = _plans(arch, batch, pipeline, train)
    reqs = mine.phase_requirements()
    assert [r.name for r in reqs] == [op.name for op in mine.ops]
    agreed = 0
    for op, req in zip(mine.ops, reqs):
        rop = ref.op(op.name)
        passes = (2 * op.n_passes if op.kernel == "votes_routing_bwd"
                  else op.n_passes)
        if (op.mode, passes) == (rop.mode, rop.n_passes):
            assert _t(req) == _t(rop.requirement), op.name
            agreed += 1
        assert _t(req) == _stated(ref, mine, op), op.name
    assert agreed >= 2                       # the conv ops at least
    assert mine.phase_durations() == {r.name: r.duration_cycles
                                      for r in reqs}


def test_streamed_backward_scales_by_the_ports_own_pass_count():
    """SVHN's bottleneck backward is streamed on the port (5 votes
    computations) and resident on the reference: its duration is the
    routing profiles plus 5 ClassCaps-FC-bwd, not the reference's 3.5."""
    _, mine = _plans("capsnet-svhn", 8, False, True)
    op = mine.op("ClassCaps-Routing[0]" + BWD_SUFFIX)
    assert (op.mode, op.n_passes) == ("streamed", 5)
    profs = mine.op_profiles(op)
    assert mine.phase_durations()[op.name] == (
        sum(p.total_cycles for p in profs[:-1])
        + 5 * profs[-1].total_cycles)


def test_streamed_global_drops_only_the_logits():
    _, mine = _plans("capsnet-cifar10", 1, False, True)
    for name in ("ClassCaps-Routing[0]", "ClassCaps-Routing[0]-bwd"):
        op = mine.op(name)
        assert op.mode == STREAMED_GLOBAL
        as_streamed = dataclasses.replace(op, mode="streamed")
        n_logits = 1 if op.kernel == "votes_routing" else 4   # b_0 .. b_3
        assert (mine.requirement(as_streamed).required_bytes
                - mine.requirement(op).required_bytes
                == n_logits * 1024 * 1024 * analysis.ACC_BYTES)
        assert mine.requirement(as_streamed).duration_cycles \
            == mine.requirement(op).duration_cycles


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("train", [False, True])
def test_evaluate_plan_and_pmu_equal_the_reference_fed_the_same_phases(
        arch, train):
    """``dse.evaluate_plan`` and ``pmu.schedule_from_plan`` on a port plan
    equal the reference's ``evaluate`` and ``build_schedule`` fed that
    plan's phases (groups, durations, requirements)."""
    ref, mine = _plans(arch, 1, True, train)
    refp = ref.profiles                    # equal to the port's by value
    groups, durations = mine.phase_groups(), mine.phase_durations()
    for sectors in (1, 128):
        orgs = dse.design_organizations(mine.profiles, sectors=sectors)
        rorgs = ref_dse.design_organizations(refp, sectors=sectors)
        for name, org in orgs.items():
            assert _ev(dse.evaluate_plan(org, mine)) == _ev(ref_dse.evaluate(
                rorgs[name], refp, phase_groups=groups,
                phase_durations=durations))
        for sram, rsram in zip(orgs["PG-SEP"].srams, rorgs["PG-SEP"].srams):
            assert _t(pmu.schedule_from_plan(sram, mine)) == _t(
                ref_pmu.build_schedule(rsram, [
                    ref_pmu.PhaseRequirement(*_t(r))
                    for r in mine.phase_requirements()]))
    assert dse.best_design(plan=mine).total_mj == min(
        r.total_mj for r in dse.explore(plan=mine))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hbm_bytes_sums_the_forward_ops(arch):
    for pipeline in (False, True):
        plan = execplan.compile_plan(registry.get_config(arch), batch=1,
                                     pipeline=pipeline, train=True)
        fwd = [op for op in plan.ops if not op.name.endswith(BWD_SUFFIX)]
        assert plan.forward_hbm_bytes() == sum(op.global_bytes
                                               for op in fwd) > 0
    cfg = registry.get_config("capsnet-mnist")
    per_op = execplan.compile_plan(cfg, batch=8)
    piped = execplan.compile_plan(cfg, batch=8, pipeline=True)
    assert piped.pipelined
    assert piped.forward_hbm_bytes() != per_op.forward_hbm_bytes()


def test_plan_table_rows():
    cfg = registry.get_config("capsnet-mnist")
    plans = [("per-op", execplan.compile_plan(cfg, batch=8)),
             ("pipelined", execplan.compile_plan(cfg, batch=8,
                                                 pipeline=True))]
    rows = execplan.plan_table(plans)
    assert [r["plan"] for r in rows] == ["per-op"] * 3 + ["pipelined"] * 2
    assert [r["name"] for r in rows] == [op.name for _, p in plans
                                         for op in p.ops]


def test_validate_rejects_a_plan_that_drops_an_operation():
    plan = execplan.compile_plan(registry.get_config("capsnet-mnist"),
                                 train=True)
    broken = dataclasses.replace(plan, ops=plan.ops[:-1])
    with pytest.raises(execplan.PlanError):
        broken.validate()


def test_example_prints_the_three_tables(capsys, monkeypatch):
    """``examples/capstore_dse_torch.py`` runs on the CPU and prints Table
    2, the sector sweep and Fig. 11's breakdown, then the planner's
    tiles of the plan's GEMMs."""
    root = Path(__file__).resolve().parents[1]
    monkeypatch.chdir(root)
    runpy.run_path(str(root / "examples" / "capstore_dse_torch.py"),
                   run_name="__main__")
    out = capsys.readouterr().out
    for head in ("== ASIC organizations (paper Table 2) ==",
                 "== sector sweep (power-gated orgs) ==",
                 "== complete accelerator with PG-SEP (Fig. 11) ==",
                 "== Hopper planner"):
        assert head in out
    assert "PrimaryCaps-bwd  dpatches" in out
