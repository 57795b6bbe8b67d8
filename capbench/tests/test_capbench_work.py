"""The work counter: FLOPs and bytes from a configuration's shapes."""

import pytest

from capbench import spec, work


def config(name: str) -> dict:
    return spec.load_json(spec.HERE / "configs" / f"{name}.json")


def test_mnist_per_image_counts():
    cfg = config("capsnet-mnist")
    assert work.conv1_flops(cfg) == 16_588_800
    assert work.primary_flops(cfg) == 382_205_952
    assert work.votes_flops(cfg) == 2_949_120
    assert work.serve_flops(cfg) == 16_588_800 + 382_205_952 + 5_529_600


def test_svhn_per_image_counts():
    cfg = config("capsnet-svhn")
    assert work.conv1_flops(cfg) == 17_915_904
    assert work.primary_flops(cfg) == 63_700_992
    assert work.routing_shapes(cfg) == [(1024, 6, 80, 3)]
    assert work.votes_flops(cfg) == 983_040


def test_routing_counts():
    assert work.routing_flops(1, 1152, 8, 160, 3) == 2.0 * 1152 * 160 * 15
    # votes once, 4 replays of 4 and the seed/reverse 6, the emit.
    assert work.routing_bwd_flops(1, 10, 8, 4, 3) == (
        2 * 10 * 4 * 8 + 4 * 4 * 10 * 4 + 6 * 10 * 4 + 3 * 10 * 4
        + 4 * 10 * 4 * 8)


@pytest.mark.parametrize("name", ["capsnet-mnist", "capsnet-svhn"])
def test_training_counts_more_than_serving(name):
    cfg = config(name)
    assert 2.5 * work.serve_flops(cfg) < work.train_flops(cfg) \
        < 4.0 * work.serve_flops(cfg)
    assert work.train_bytes(cfg, 64) > work.serve_bytes(cfg, 64)


def test_bound_names_the_peak_that_binds():
    t, which = work.bound_s(67e12, 1.0)
    assert (t, which) == (pytest.approx(1.0), "operations")
    t, which = work.bound_s(1.0, 3.35e12)
    assert (t, which) == (pytest.approx(1.0), "bytes")


def test_param_count_is_the_references():
    from capbench.reference import capsnet_ref
    import math
    for name in ("capsnet-mnist", "capsnet-svhn"):
        cfg = config(name)
        n = sum(math.prod(s) for s, _ in capsnet_ref.param_shapes(cfg).values())
        assert work.param_count(cfg, decoder=True) == n
