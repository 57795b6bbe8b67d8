"""The port's sharding rules (``repro_torch.parallel.sharding``) and cell
shapes (``repro_torch.launch.shapes`` / ``mesh``) against the reference's.

The rules are pure functions of the shapes and the mesh's axis sizes, so
they are held to the reference's at the production mesh sizes (16x16 and
2x16x16) with no process group: the port's trees are built on
``device="meta"`` (``launch.shapes``), the reference's with
``jax.eval_shape``, and every leaf's spec must be equal as a tuple --
``param_pspecs`` and ``zero1_pspecs`` for every LM arch of the registry
at both train and serve dtypes, ``cache_leaf_pspec`` for every runnable
decode cell under both KV modes.  The activation table, the ``sp``
toggle, the skip policy and the 34 runnable cells match too.
"""

import types

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import LM_ARCHS as REF_ARCHS
from repro.configs import get_config as ref_config
from repro.launch import shapes as ref_shapes
from repro.parallel import sharding as ref_sharding
from repro_torch import tree
from repro_torch.configs import registry
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import shapes
from repro_torch.parallel import sharding

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
ACT_KINDS = ("tokens", "btd", "btf", "bthd", "btkd", "logits", "bte",
             "ecd", "becd", "frames")


def _ref_mesh(name):
    sizes, axes = MESHES[name]
    return types.SimpleNamespace(shape=dict(zip(axes, sizes)))


def _port_mesh(name):
    sizes, axes = MESHES[name]
    return lmesh.AbstractMesh(axes, sizes)


def _key(p):
    return p.key if hasattr(p, "key") else p.idx


def _ref_by_path(tree_of_specs, shapes_tree):
    """Reference specs keyed by the port's path (dict keys, list
    indices)."""
    flat_shapes, _ = jax.tree_util.tree_flatten_with_path(shapes_tree)
    flat_specs = jax.tree_util.tree_leaves(
        tree_of_specs, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))
    return {tuple(_key(p) for p in path): tuple(s)
            for (path, _), s in zip(flat_shapes, flat_specs, strict=True)}


def _port_by_path(specs):
    return dict(_walk_specs(specs))


def _walk_specs(specs, prefix=()):
    """(path, spec) of a tree whose leaves are ``sharding.P`` (tuples)."""
    if isinstance(specs, sharding.P):
        yield prefix, tuple(specs)
    elif isinstance(specs, dict):
        for k in sorted(specs):
            yield from _walk_specs(specs[k], prefix + (k,))
    elif isinstance(specs, list):
        for i, v in enumerate(specs):
            yield from _walk_specs(v, prefix + (i,))


def test_the_registries_agree():
    assert list(registry.LM_ARCHS) == list(REF_ARCHS)


@pytest.mark.parametrize("dtype", ["train", "serve"])
@pytest.mark.parametrize("arch", list(registry.LM_ARCHS))
def test_param_and_zero1_specs_match_the_reference(arch, dtype):
    tdt, jdt = ((torch.float32, jnp.float32) if dtype == "train"
                else (torch.bfloat16, jnp.bfloat16))
    ref_params = ref_shapes.param_specs(ref_config(arch), jdt)
    params = shapes.param_specs(registry.get_config(arch), tdt)
    assert all(t.device.type == "meta" for t in tree.leaves(params))
    got = _port_by_path(sharding.param_pspecs(params))
    want = _ref_by_path(ref_sharding.param_pspecs(ref_params), ref_params)
    assert got == want
    # Shapes and dtypes agree leaf for leaf.
    ref_leaves = {tuple(_key(p) for p in path): (tuple(s.shape), str(
        s.dtype)) for path, s in jax.tree_util.tree_flatten_with_path(
            ref_params)[0]}
    assert {path: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for path, t in tree.leaves_with_path(params)} == ref_leaves
    for name in MESHES:
        for dp in (("data",), ("pod", "data")) if name == "multipod" \
                else (("data",),):
            got = _port_by_path(sharding.zero1_pspecs(
                params, _port_mesh(name), dp))
            want = _ref_by_path(ref_sharding.zero1_pspecs(
                ref_params, _ref_mesh(name), dp), ref_params)
            assert got == want, (name, dp)


@pytest.mark.parametrize("arch", list(registry.LM_ARCHS))
def test_cache_specs_match_the_reference_in_every_cell(arch):
    cfg, rcfg = registry.get_config(arch), ref_config(arch)
    checked = 0
    for shape_name, spec in shapes.SHAPES.items():
        if spec.kind != "decode" or not shapes.cell_supported(cfg, spec)[0]:
            continue
        cache = shapes.cache_specs(cfg, spec)
        ref_cache = ref_shapes.cache_specs(rcfg, ref_shapes.SHAPES[
            shape_name])
        ref_flat = jax.tree_util.tree_flatten_with_path(ref_cache)[0]
        port_flat = list(tree.leaves_with_path(cache))
        assert [tuple(_key(p) for p in path) for path, _ in ref_flat] == \
            [path for path, _ in port_flat]
        for name in MESHES:
            for kv_mode in ("heads", "seq"):
                rules = sharding.make_rules(name == "multipod",
                                            kv_mode=kv_mode)
                ref_rules = ref_sharding.make_rules(name == "multipod",
                                                    kv_mode=kv_mode)
                for (rpath, rleaf), (path, leaf) in zip(ref_flat,
                                                        port_flat):
                    assert tuple(leaf.shape) == tuple(rleaf.shape)
                    got = sharding.cache_leaf_pspec(
                        path, tuple(leaf.shape), rules, _port_mesh(name))
                    want = ref_sharding.cache_leaf_pspec(
                        rpath, rleaf.shape, ref_rules, _ref_mesh(name))
                    assert tuple(got) == tuple(want), (shape_name, path)
                    checked += 1
        shardings = sharding.cache_shardings(cache, sharding.make_rules(),
                                             _port_mesh("pod"))
        assert [s.spec for _, s in tree.leaves_with_path(shardings)] == [
            sharding.cache_leaf_pspec(path, tuple(leaf.shape),
                                      sharding.make_rules(),
                                      _port_mesh("pod"))
            for path, leaf in port_flat]
    assert checked or not cfg.has_decode


def test_spec_for_path_matches_the_reference():
    paths = [("embed", 2), ("blocks/s0/q_proj", 3), ("blocks/s0/o_proj", 3),
             ("prefix/0/down_proj", 2), ("blocks/s0/experts_gate", 4),
             ("blocks/s0/input_norm", 2), ("shared/kv_down", 2),
             ("unembed", 2), ("blocks/s1/conv_b", 2), ("frontend_proj", 2),
             ("cc_w", 4), ("blocks/s0/a_log", 1), ("something_else", 3)]
    for path, ndim in paths:
        assert tuple(sharding._spec_for_path(path, ndim)) == \
            tuple(ref_sharding._spec_for_path(path, ndim)), path
    assert sharding._path_str(("prefix", 0, "down_proj")) == \
        "prefix/0/down_proj"


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("sp", [True, False])
def test_act_table_and_sp_toggle(multi_pod, sp):
    for kv_mode in ("heads", "seq"):
        got = sharding.make_rules(multi_pod, sp=sp, kv_mode=kv_mode)
        want = ref_sharding.make_rules(multi_pod, sp=sp, kv_mode=kv_mode)
        assert got.dp == want.dp
        for kind in ACT_KINDS:
            assert tuple(got.act(kind)) == tuple(want.act(kind)), kind
        for stacked in (True, False):
            assert tuple(got.kv_cache(stacked)) == \
                tuple(want.kv_cache(stacked))
            assert tuple(got.ssm_cache(stacked)) == \
                tuple(want.ssm_cache(stacked))
    r = sharding.make_rules(sp=sp)
    assert r.act("btd")[1] == ("model" if sp else None)


def test_skip_policy_and_runnable_cells():
    runnable = 0
    for arch in registry.LM_ARCHS:
        cfg, rcfg = registry.get_config(arch), ref_config(arch)
        for name, spec in shapes.SHAPES.items():
            rspec = ref_shapes.SHAPES[name]
            assert (spec.kind, spec.seq_len, spec.global_batch) == \
                (rspec.kind, rspec.seq_len, rspec.global_batch)
            ok, why = shapes.cell_supported(cfg, spec)
            assert ok == ref_shapes.cell_supported(rcfg, rspec)[0]
            runnable += ok
            if not ok:
                with pytest.raises(ValueError, match="skipped"):
                    shapes.input_specs(cfg, name)
    assert runnable == 34


def test_input_specs_build_on_meta():
    cfg = registry.get_config("granite-3-2b")
    spec = shapes.input_specs(cfg, "train_4k")
    assert spec["kind"] == "train"
    assert spec["batch"]["inputs"].shape == (256, 4096)
    assert all(t.device.type == "meta" for t in tree.leaves(
        spec["opt_state"]))
    dec = shapes.input_specs(cfg, "decode_32k")
    assert dec["token"].shape == (128, 1) and dec["index"].dim() == 0
    assert dec["params"]["embed"].dtype == torch.bfloat16
    hub = shapes.input_specs(registry.get_config("hubert-xlarge"),
                             "prefill_32k")
    assert hub["tokens"].shape[-1] == registry.get_config(
        "hubert-xlarge").frontend_dim


def test_production_mesh_is_abstract_without_a_process_group():
    m = lmesh.make_production_mesh()
    assert isinstance(m, lmesh.AbstractMesh)
    assert m.shape == {"data": 16, "model": 16} and lmesh.mesh_chips(m) \
        == 256
    mp = lmesh.make_production_mesh(multi_pod=True)
    assert mp.shape == {"pod": 2, "data": 16, "model": 16}
    assert lmesh.mesh_chips(mp) == 512
    assert sharding.axes_size(mp, ("pod", "data")) == 32
