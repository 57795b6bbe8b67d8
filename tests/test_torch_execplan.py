"""The Hopper ExecutionPlan: schedules, shared-memory budget, op names.

The plan is derived again for the H100 (227 KB of shared memory per CTA,
one CTA per sample for routing), so its modes differ from the TPU plan's
at full width, while its op names stay the reference's.
"""

import pytest
import torch

from repro.configs import capsnet_mnist as ref_mnist
from repro.core import execplan as ref_execplan
from repro_torch.configs import capsnet_mnist, capsnet_svhn
from repro_torch.core import capsnet, execplan, planner
from repro_torch.core.capsnet import CapsNetConfig
from repro_torch.core.execplan import (FUSED_NAME, PIPE_NAME, PlanError,
                                       compile_plan, plan_votes_routing,
                                       plan_votes_routing_cluster)
from repro_torch.kernels import ops

CONFIGS = {"mnist": capsnet_mnist.config(),
           "smoke": capsnet_mnist.smoke_config()}
REF_CONFIGS = {"mnist": ref_mnist.config(),
               "smoke": ref_mnist.smoke_config()}


def test_full_width_mnist_streams_and_pipelines():
    cfg = capsnet_mnist.config()
    plan = compile_plan(cfg, batch=8, pipeline=True)
    assert plan.pipelined
    pr = plan.op(PIPE_NAME)
    # K5 routes each sample over a cluster: 8 CTAs of 144 capsule rows each,
    # whose votes fit their CTAs, so the consume is resident, as in the
    # reference's plan.
    assert (pr.kernel, pr.mode, pr.n_passes, pr.cluster) == (
        "primary_routing", "resident", 1, 8)
    assert pr.mode == ref_execplan.compile_plan(
        ref_mnist.config(), batch=8, pipeline=True).op(PIPE_NAME).mode
    perop = compile_plan(cfg, batch=8, pipeline=False)
    vr = perop.op(FUSED_NAME)
    # One sample's votes (1152 x 160 fp32) exceed a CTA's shared memory,
    # but a cluster CTA's rows' votes fit: K3 keeps them resident.
    assert 1152 * 160 * 4 > planner.SMEM_BYTES
    assert (vr.kernel, vr.mode, vr.n_passes, vr.cluster) == (
        "votes_routing", "resident", 1, 16)
    assert vr.block.rows == vr.block_i == 72


def test_smoke_config_keeps_the_votes_resident():
    cfg = capsnet_mnist.smoke_config()
    assert compile_plan(cfg, batch=8,
                        pipeline=True).op(PIPE_NAME).mode == "resident"
    assert compile_plan(cfg, batch=8,
                        pipeline=False).op(FUSED_NAME).mode == "resident"


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("pipeline", [True, False])
@pytest.mark.parametrize("batch", [1, 8, 64])
def test_every_op_fits_one_cta(name, pipeline, batch):
    plan = compile_plan(CONFIGS[name], batch=batch, pipeline=pipeline)
    for op in plan.ops:
        assert 0 < op.smem_bytes <= planner.SMEM_BYTES == 232_448, op.name


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("pipeline", [True, False])
def test_op_names_match_the_reference_plan(name, pipeline):
    want = [op.name for op in ref_execplan.compile_plan(
        REF_CONFIGS[name], batch=8, pipeline=pipeline).ops]
    got = [op.name for op in compile_plan(CONFIGS[name], batch=8,
                                          pipeline=pipeline).ops]
    assert got == want


def test_routing_footprint_does_not_grow_with_the_batch():
    """At each cluster size the schedule and its footprint are the same
    at batch 1 and 512; only the chosen size (and its waves) follows the
    batch."""
    cfg = capsnet_mnist.config()
    small = compile_plan(cfg, batch=1, pipeline=False).op(FUSED_NAME)
    big = compile_plan(cfg, batch=512, pipeline=False).op(FUSED_NAME)
    for op in (small, big):
        again = plan_votes_routing_cluster(1152, 8, 160, 10, batch=1,
                                           cluster=op.cluster)
        assert (op.mode, op.block_i, op.smem_bytes) == (
            again.mode, again.block_i, again.smem_bytes)
        assert op.smem_bytes <= planner.SMEM_BYTES


def test_primary_caps_squash_always_fuses():
    for pd in (4, 6, 8, 12):
        cfg = CapsNetConfig(image_hw=14, conv1_channels=24, conv1_kernel=5,
                            pc_kernel=3, num_primary_groups=4, primary_dim=pd,
                            class_dim=8, decoder_hidden=(32, 64))
        op = compile_plan(cfg, batch=2).op("PrimaryCaps")
        assert op.fuses_squash
        assert op.block.block_n % pd == 0


@pytest.mark.parametrize("arch", ["mnist", "svhn"])
def test_primary_caps_gemm_fills_the_card_and_short_k_does_not_split(arch):
    """At serving batch 8 the PrimaryCaps GEMM's tiles x K splits give at
    least one CTA per SM; Conv1 (K = 81 or 243) and the dpatches GEMM
    (K = 256, hundreds of tiles) keep one split.  The partials count in
    the modeled bytes."""
    cfg = {"mnist": capsnet_mnist.config(), "svhn": capsnet_svhn.config()}[
        arch]
    plan = compile_plan(cfg, batch=8, pipeline=False, train=True)
    pc, conv1 = plan.op("PrimaryCaps").block, plan.op("Conv1").block
    m = 8 * cfg.pc_out ** 2
    assert pc.split_k > 1 and pc.ctas >= planner.NUM_SMS
    assert pc.ctas == (-(-m // pc.block_m)
                       * -(-cfg.pc_channels // pc.block_n) * pc.split_k)
    assert pc.hbm_bytes >= 2 * pc.split_k * m * cfg.pc_channels * 4
    # Split, the squash runs in the reduction pass: no staged output.
    assert pc.smem_bytes == planner.gemm_smem_bytes(
        pc.block_m, pc.block_k, pc.block_n)
    assert conv1.split_k == 1
    assert plan.bwd_op("PrimaryCaps").dx_block.split_k == 1
    split, slab = planner.split_slab(cfg.pc_kernel ** 2 * cfg.conv1_channels,
                                     pc.split_k, pc.block_k)
    assert split == pc.split_k and slab % pc.block_k == 0
    assert slab >= planner.SPLIT_K_MIN


def test_plan_error_names_the_op():
    # Even streamed-global block_i=1 on a 16-CTA cluster needs 5548 B.
    with pytest.raises(PlanError, match=FUSED_NAME):
        plan_votes_routing(1152, 8, 160, 10, smem_budget=5_000)
    with pytest.raises(PlanError, match="Conv1"):
        compile_plan(capsnet_mnist.config(), batch=8, smem_budget=1_000)
    # A capsule no GEMM tile width holds no longer refuses to plan: the
    # PrimaryCaps op runs the plain GEMM and the standalone squash (K10).
    wide = CapsNetConfig(image_hw=14, conv1_channels=24, conv1_kernel=5,
                         pc_kernel=3, num_primary_groups=1, primary_dim=200,
                         class_dim=8, decoder_hidden=(32, 64))
    assert not compile_plan(wide, batch=1).op("PrimaryCaps").fuses_squash


def test_pipelined_plan_falls_back_to_per_op_past_the_kernel_limits():
    """36x36 images give 10x10 = 100 PrimaryCaps positions, more than the
    pipelined producer's 64: the plan keeps the per-op pair."""
    cfg = CapsNetConfig(image_hw=36)
    plan = compile_plan(cfg, batch=1, pipeline=True)
    assert not plan.pipelined
    assert [op.name for op in plan.ops] == ["Conv1", "PrimaryCaps",
                                            FUSED_NAME]


def test_validate_and_summary():
    plan = compile_plan(capsnet_mnist.config(), batch=8, pipeline=True)
    rows = plan.summary()
    assert [r["name"] for r in rows] == ["Conv1", PIPE_NAME]
    assert rows[1]["block_k"] == plan.op(PIPE_NAME).block_k
    with pytest.raises(KeyError):
        plan.op("PrimaryCaps")
    with pytest.raises(PlanError, match="batch"):
        execplan.ExecutionPlan(cfg=plan.cfg, batch=0, smem_budget=1,
                               ops=plan.ops).validate()


def test_plan_caches_are_bounded():
    for fn in (ops.planned_conv_blocks, ops.planned_votes_routing,
               ops.planned_primary_routing, compile_plan):
        assert fn.cache_info().maxsize == 64


def test_planless_ops_run_the_memoized_plan_decision():
    cfg = capsnet_mnist.smoke_config()
    params = capsnet.init_params(torch.Generator().manual_seed(0), cfg,
                                 device="cpu")
    x = torch.rand(2, cfg.image_hw, cfg.image_hw, 1,
                   generator=torch.Generator().manual_seed(1))
    plan = compile_plan(cfg, batch=2, pipeline=True)
    perop = compile_plan(cfg, batch=2, pipeline=False)
    h = ops.conv2d(x, params["conv1_w"], params["conv1_b"], epilogue="relu")
    torch.testing.assert_close(h, ops.conv2d(
        x, params["conv1_w"], params["conv1_b"], plan_op=plan.op("Conv1"),
        epilogue="relu"))
    w_cc = params["cc_w"].reshape(cfg.num_primary, -1, cfg.primary_dim)
    torch.testing.assert_close(
        ops.primary_routing(h, params["pc_w"], params["pc_b"], w_cc),
        ops.primary_routing(h, params["pc_w"], params["pc_b"], w_cc,
                            plan=plan))
    u = ops.conv2d(h, params["pc_w"], params["pc_b"], stride=2,
                   epilogue="squash", squash_dim=cfg.primary_dim)
    u = u.reshape(2, cfg.num_primary, cfg.primary_dim)
    torch.testing.assert_close(ops.votes_routing(u, w_cc),
                               ops.votes_routing(u, w_cc, plan=perop))
    mode, block_i, cs = ops.planned_votes_routing(cfg.num_primary,
                                                  cfg.primary_dim, 80, 10, 3)
    assert (mode, block_i) == ("resident", -(-cfg.num_primary // cs))
