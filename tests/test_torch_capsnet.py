"""The port's CapsuleNet against the reference, end to end on the CPU.

At ``smoke_config`` and a 2-sample batch, the port's ``forward`` on both
backends (``torch``; ``kernels`` with the pipelined and the per-op plan,
whose wrappers run their plain twins on CPU tensors) matches the
reference's ``forward(backend="jnp")`` and ``forward(backend="pallas")``
in class capsules, lengths and reconstruction, at the reference's
forward tolerance (tests/test_capsnet.py: 1e-5).  The reference's
parameters move over through ``convert.params_from_numpy``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import capsnet_mnist as ref_mnist
from repro.configs.registry import CAPSNET_ARCHS, get_config, get_smoke_config
from repro.core import capsnet as R
from repro_torch.configs import capsnet_mnist
from repro_torch.convert import params_from_numpy
from repro_torch.core import capsnet as T
from repro_torch.core import execplan

KEYS = ("class_caps", "lengths", "reconstruction")


def to_port(cfg: R.CapsNetConfig) -> T.CapsNetConfig:
    """The port's config with the same fields as a reference config."""
    layers = tuple(
        T.ResCapsBlock(e.routing_iters) if isinstance(e, R.ResCapsBlock)
        else T.CapsLayerSpec(e.num_caps, e.caps_dim, e.routing_iters)
        for e in cfg.caps_layers)
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg) if f.name != "caps_layers"}
    return T.CapsNetConfig(**fields, caps_layers=layers)


@pytest.fixture(scope="module")
def smoke():
    cfg_r = ref_mnist.smoke_config()
    params_r = R.init_params(jax.random.PRNGKey(0), cfg_r)
    images = np.random.default_rng(0).random((2, 14, 14, 1), np.float32)
    refs = {backend: {k: np.asarray(v) for k, v in R.forward(
        params_r, jnp.asarray(images), cfg_r, backend=backend).items()}
        for backend in ("jnp", "pallas")}
    params = params_from_numpy({k: np.asarray(v)
                                for k, v in params_r.items()}, "cpu")
    return capsnet_mnist.smoke_config(), params, images, refs


def test_configs_match_the_reference():
    assert capsnet_mnist.config() == to_port(ref_mnist.config())
    assert capsnet_mnist.smoke_config() == to_port(ref_mnist.smoke_config())


@pytest.mark.parametrize("arch", CAPSNET_ARCHS)
@pytest.mark.parametrize("smoke_widths", [False, True])
def test_routing_stack_matches_reference(arch, smoke_widths):
    cfg_r = (get_smoke_config if smoke_widths else get_config)(arch)
    want = [dataclasses.astuple(lay) for lay in cfg_r.routing_stack()]
    got = [dataclasses.astuple(lay) for lay in to_port(cfg_r).routing_stack()]
    assert got == want


@pytest.mark.parametrize("pipeline", [None, True, False])
@pytest.mark.parametrize("backend_ref", ["jnp", "pallas"])
def test_forward_kernels_matches_reference(smoke, pipeline, backend_ref):
    cfg, params, images, refs = smoke
    plan = (None if pipeline is None else
            execplan.compile_plan(cfg, batch=2, pipeline=pipeline))
    out = T.forward(params, images, cfg, backend="kernels", plan=plan,
                    device="cpu")
    for k in KEYS:
        np.testing.assert_allclose(out[k].numpy(), refs[backend_ref][k],
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("backend_ref", ["jnp", "pallas"])
def test_forward_torch_matches_reference(smoke, backend_ref):
    cfg, params, images, refs = smoke
    out = T.forward(params, images, cfg, backend="torch", device="cpu")
    for k in KEYS:
        np.testing.assert_allclose(out[k].numpy(), refs[backend_ref][k],
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_decode_with_labels_and_margin_loss_match_reference(smoke):
    cfg, params, images, refs = smoke
    cfg_r = ref_mnist.smoke_config()
    params_r = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    v = refs["jnp"]["class_caps"].copy()
    labels = np.array([3, 7])
    want = R.decode(params_r, jnp.asarray(v), cfg_r,
                    labels=jnp.asarray(labels))
    got = T.decode(params, torch.from_numpy(v), cfg,
                   labels=torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    lengths = refs["jnp"]["lengths"].copy()
    np.testing.assert_allclose(
        T.margin_loss(torch.from_numpy(lengths),
                      torch.from_numpy(labels)).item(),
        float(R.margin_loss(jnp.asarray(lengths), jnp.asarray(labels))),
        rtol=1e-6)


def test_routing_keeps_the_stop_gradient_convention():
    """Gradients of the routed output reach u_hat only through the last
    iteration's s and the readout, as in the reference."""
    uh = np.random.default_rng(1).standard_normal((2, 12, 3, 4)).astype(
        np.float32)

    def loss_r(x):
        return jnp.sum(R.routing_by_agreement(x, 3) ** 2)

    want = np.asarray(jax.grad(loss_r)(jnp.asarray(uh)))
    x = torch.from_numpy(uh).requires_grad_()
    torch.sum(T.routing_by_agreement(x, 3) ** 2).backward()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-5, atol=1e-6)


def test_init_params_keys_and_shapes_match_reference():
    for cfg_r in (ref_mnist.smoke_config(), get_smoke_config("capsnet-svhn")):
        want = {k: v.shape for k, v in
                R.init_params(jax.random.PRNGKey(0), cfg_r).items()}
        got = T.init_params(torch.Generator().manual_seed(0), to_port(cfg_r),
                            device="cpu")
        assert {k: tuple(v.shape) for k, v in got.items()} == want


def test_kernels_backend_runs_residual_stacks():
    """The kernels backend walks a ResCaps stack (the reversible segment,
    K12) and matches the plain backend on the CIFAR-10 smoke config."""
    cfg = to_port(get_smoke_config("capsnet-cifar10"))
    params = T.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    images = torch.tensor(np.random.default_rng(0).random(
        (2, cfg.image_hw, cfg.image_hw, cfg.in_channels), np.float32))
    got = T.forward(params, images, cfg, backend="kernels", device="cpu")
    want = T.forward(params, images, cfg, backend="torch", device="cpu")
    assert got["lengths"].shape == (2, cfg.num_classes)
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_forward_rejects_unknown_backend_and_misplaced_params(smoke):
    cfg, params, images, _ = smoke
    with pytest.raises(ValueError, match="unknown backend"):
        T.forward(params, images, cfg, backend="jnp", device="cpu")
    moved = dict(params, conv1_b=params["conv1_b"].to("meta"))
    with pytest.raises(ValueError, match="conv1_b"):
        T.forward(moved, images, cfg, device="cpu")
