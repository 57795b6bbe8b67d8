"""The port's roofline (``launch/roofline.py``) against the reference's
(``repro/launch/roofline.py``, ``repro/launch/hlo_analysis.py``) on the
CPU: the same formulas, the H100's constants in place of the TPU's.

  * the terms with the H100 constants: 989e12 flops -> 1.0 s, 3.35e12 B
    -> 1.0 s, mfu 0.5, 3 x 450e9 collective bytes -> a 3.0 s collective
    bottleneck;
  * the ring formulas at S in {1, 2, 4, 16} for each collective equal the
    reference's ``_collective_moved``;
  * ``model_flops_for`` equals the reference's in every (arch x shape)
    cell;
  * each term equals the reference's on the same counts, scaled by the
    ratio of the two constants; ``useful_flops_ratio`` equal as it is.
"""

import pytest

from repro.configs import LM_ARCHS as REF_ARCHS
from repro.configs import get_config as ref_config
from repro.launch import hlo_analysis as ref_ha
from repro.launch import roofline as ref_rf
from repro.launch.shapes import SHAPES as REF_SHAPES
from repro.models.config import count_params as ref_count
from repro_torch.configs import registry
from repro_torch.launch import roofline as rf
from repro_torch.launch.shapes import SHAPES
from repro_torch.models import count_params


def test_roofline_terms_and_bottleneck():
    r = rf.Roofline(flops_per_device=989e12, hbm_bytes_per_device=3.35e12,
                    collective_bytes_per_device=0.0, chips=4,
                    model_flops=4 * 989e12 * 0.5)
    assert r.compute_s == pytest.approx(1.0)
    assert r.memory_s == pytest.approx(1.0)
    assert r.bottleneck in ("compute", "memory")
    assert r.mfu == pytest.approx(0.5)
    r2 = rf.Roofline(flops_per_device=1.0, hbm_bytes_per_device=1.0,
                     collective_bytes_per_device=450e9 * 3, chips=1,
                     model_flops=1.0)
    assert r2.bottleneck == "collective"
    assert r2.collective_s == pytest.approx(3.0)
    assert r2.step_time_s == r2.collective_s


def test_constants_are_the_h100s():
    assert (rf.PEAK_FLOPS, rf.HBM_BW, rf.LINK_BW) == (989e12, 3.35e12, 450e9)


@pytest.mark.parametrize("s", [1, 2, 4, 16])
@pytest.mark.parametrize("kind", rf.COLLECTIVES)
def test_ring_formulas_equal_the_reference(kind, s):
    op = ref_ha.Op(name="%x", opcode=kind, type_str="f32[100]", line="",
                   operands=[])
    assert rf.collective_moved(kind, 400.0, s) == ref_ha._collective_moved(
        op, s)


def test_unknown_collective_is_refused():
    with pytest.raises(ValueError, match="unknown collective"):
        rf.collective_moved("broadcast", 4.0, 2)


@pytest.mark.parametrize("shape", list(REF_SHAPES))
@pytest.mark.parametrize("arch", REF_ARCHS)
def test_model_flops_equal_the_reference(arch, shape):
    cfg, rcfg = registry.get_config(arch), ref_config(arch)
    n, rn = count_params(cfg, active_only=True), ref_count(rcfg,
                                                          active_only=True)
    assert n == rn
    assert rf.model_flops_for(cfg, SHAPES[shape], n) == \
        ref_rf.model_flops_for(rcfg, REF_SHAPES[shape], rn)


@pytest.mark.parametrize("counts", [
    (4.0e14, 4.9e13, 1.7e11, 256, 1.6e16),     # a train cell's order
    (7.9e9, 1.05e11, 2.1e10, 256, 6.5e11),     # a decode cell's
    (1.0, 1.0, 0.0, 1, 1.0),
])
def test_terms_equal_the_reference_scaled_by_the_constants(counts):
    flops, hbm, coll, chips, model = counts
    kw = dict(flops_per_device=flops, hbm_bytes_per_device=hbm,
              collective_bytes_per_device=coll, chips=chips,
              model_flops=model)
    got, ref = rf.Roofline(**kw), ref_rf.Roofline(**kw)
    assert got.compute_s == pytest.approx(
        ref.compute_s * ref_rf.PEAK_FLOPS / rf.PEAK_FLOPS, rel=1e-12)
    assert got.memory_s == pytest.approx(
        ref.memory_s * ref_rf.HBM_BW / rf.HBM_BW, rel=1e-12)
    assert got.collective_s == pytest.approx(
        ref.collective_s * ref_rf.ICI_BW / rf.LINK_BW, rel=1e-12)
    assert got.useful_flops_ratio == ref.useful_flops_ratio
    assert set(got.to_dict()) == set(ref.to_dict())


def test_hbm_bytes_estimate_keeps_the_reference_rule():
    mem = {"argument_bytes": 10, "output_bytes": 20,
           "activation_bytes": 30}
    assert rf.hbm_bytes_estimate(123.0, mem) == 123.0
    assert rf.hbm_bytes_estimate(None, mem) == 10 + 20 + 2 * 30
    assert ref_rf.hbm_bytes_estimate(
        {}, {"argument_size_in_bytes": 10, "output_size_in_bytes": 20,
             "temp_size_in_bytes": 30}) == 10 + 20 + 2 * 30
