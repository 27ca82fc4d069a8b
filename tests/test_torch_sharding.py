"""The port's logical-axis resolution (dist/sharding.py, configs/common.py,
the models' ``param_axes``) against the JAX package's, with no process
group and no JAX compile.

* ``spec_for_shape`` equals ``repro.dist.sharding.spec_for_shape`` for all
  four rules tables on a 16 x 16 ("data", "model") and a 2 x 16 x 16
  ("pod", "data", "model") mesh, under hypothesis, over the shapes of
  tests/test_sharding.py and random logical names; the port resolves on
  the meshes' dim names and sizes alone.
* For every config id, each parameter of the port's ``param_axes`` has
  the reference's logical axes and shape and resolves to the reference's
  spec on both meshes, for all four tables.  Leaves are matched by the
  names ``params_from_numpy`` maps (the port's per-layer list against
  the reference's list, or against its ``scan_layers`` stack with the
  ``layers`` axis dropped).
* ``batch_structs`` and ``batch_axes`` equal the reference's for every
  config and shape.
* ``constrain`` outside a context returns its input object.
"""

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st
from jax.sharding import Mesh

from repro import configs as jconfigs
from repro.configs import common as jcommon
from repro.dist import sharding as jshd
from repro.models.registry import build_model as jbuild_model

from repro_torch import configs as tconfigs
from repro_torch.configs import common as tcommon
from repro_torch.dist import sharding as shd
from repro_torch.models.registry import build_model
from repro_torch.train.checkpoint import _flatten_with_names


def _jmesh(shape, axes):
    # an abstract mesh over a device grid: never touches the device count
    devs = np.array(jax.devices() * int(np.prod(shape)))[: int(np.prod(shape))]
    return Mesh(devs.reshape(shape), axes)


MESHES = [
    ({"data": 16, "model": 16}, _jmesh((16, 16), ("data", "model"))),
    ({"pod": 2, "data": 16, "model": 16},
     _jmesh((2, 16, 16), ("pod", "data", "model"))),
]
RULES = {"default": (shd.DEFAULT_RULES, jshd.DEFAULT_RULES),
         "serve": (shd.SERVE_RULES, jshd.SERVE_RULES),
         "context": (shd.CONTEXT_RULES, jshd.CONTEXT_RULES),
         "decode": (shd.DECODE_RULES, jshd.DECODE_RULES)}
NAMES = [None, "batch", "seq", "heads", "kv_heads", "head_dim", "embed",
         "fsdp", "vocab", "mlp", "expert_mlp", "experts", "state", "layers",
         "unknown"]
DIMS = [1, 2, 6, 8, 16, 24, 32, 64, 100, 128, 256, 4096, 5120, 32768]


def _jspec(names, shape, jmesh, rules) -> tuple:
    spec = tuple(jshd.spec_for_shape(tuple(names), tuple(shape), jmesh,
                                     rules))
    return spec + (None,) * (len(shape) - len(spec))


def test_rules_tables_are_the_reference_s():
    for port, ref in RULES.values():
        assert list(port.items()) == list(ref.items())


@given(batch=st.sampled_from([1, 2, 16, 32, 128, 256]),
       seq=st.sampled_from([1, 8, 4096, 32768, 100]),
       heads=st.sampled_from([6, 8, 16, 24, 32, 64]),
       hd=st.sampled_from([64, 128]),
       table=st.sampled_from(sorted(RULES)))
@settings(max_examples=60, deadline=None)
def test_spec_for_shape_is_the_reference_s(batch, seq, heads, hd, table):
    port_rules, ref_rules = RULES[table]
    names = ("batch", "seq", "heads", "head_dim")
    shape = (batch, seq, heads, hd)
    for sizes, jmesh in MESHES:
        assert shd.spec_for_shape(names, shape, sizes, port_rules) == \
            _jspec(names, shape, jmesh, ref_rules)


@given(axes=st.lists(st.tuples(st.sampled_from(NAMES),
                               st.sampled_from(DIMS)),
                     min_size=1, max_size=4),
       table=st.sampled_from(sorted(RULES)))
@settings(max_examples=80, deadline=None)
def test_any_logical_names_resolve_as_the_reference_s(axes, table):
    port_rules, ref_rules = RULES[table]
    names, shape = zip(*axes)
    for sizes, jmesh in MESHES:
        assert shd.spec_for_shape(names, shape, sizes, port_rules) == \
            _jspec(names, shape, jmesh, ref_rules)


def test_the_reference_s_examples():
    sizes, sizes3 = MESHES[0][0], MESHES[1][0]
    rule = ("batch", "seq", "heads", "head_dim")
    assert shd.spec_for_shape(rule, (256, 4096, 24, 128), sizes)[1:3] == (
        "model", None)
    assert shd.spec_for_shape(rule, (256, 4096, 64, 128), sizes)[1:3] == (
        None, "model")
    assert shd.spec_for_shape(("batch", "seq", "embed"), (256, 4096, 5120),
                              sizes) == ("data", "model", None)
    assert shd.spec_for_shape(("batch", "seq", "embed"), (256, 4096, 5120),
                              sizes3)[0] == ("pod", "data")
    assert shd.spec_for_shape(("fsdp", "mlp"), (5120, 27648), sizes,
                              shd.SERVE_RULES) == (None, "model")
    with pytest.raises(ValueError, match="do not match"):
        shd.spec_for_shape(("batch",), (2, 3), sizes)


def _axes_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [a for v in tree.values() for a in _axes_leaves(v)]
    if isinstance(tree, list):
        return [a for v in tree for a in _axes_leaves(v)]
    return [tree]


def _port_leaves(cfg) -> dict:
    """name -> (logical axes, shape) of the port's parameters."""
    bundle = build_model(cfg, device="cpu")
    structs = _flatten_with_names(bundle.param_structs())
    return {n: (a, tuple(s.shape)) for (n, s), a in zip(
        structs.items(), _axes_leaves(bundle.param_axes()), strict=True)}


def _reference_leaves(cfg) -> dict:
    """name -> (logical axes, shape) of the reference's parameters, a
    ``scan_layers`` stack split into the port's per-layer names with its
    ``layers`` axis dropped."""
    bundle = jbuild_model(cfg)
    structs = dict((jax.tree_util.keystr(p), s) for p, s in
                   jax.tree_util.tree_flatten_with_path(
                       bundle.param_structs())[0])
    out = {}
    for path, axes in jax.tree_util.tree_flatten_with_path(
            bundle.param_axes(),
            is_leaf=lambda x: isinstance(x, tuple))[0]:
        name, shape = jax.tree_util.keystr(path), structs[
            jax.tree_util.keystr(path)].shape
        if axes and axes[0] == "layers":
            assert name.startswith("['layers']"), name
            for i in range(shape[0]):
                out[f"['layers'][{i}]" + name[len("['layers']"):]] = (
                    tuple(axes[1:]), tuple(shape[1:]))
        else:
            out[name] = (tuple(axes), tuple(shape))
    return out


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_param_axes_resolve_as_the_reference_s(arch):
    port = _port_leaves(tconfigs.get_config(arch))
    ref = _reference_leaves(jconfigs.get_config(arch))
    assert list(port) == list(ref) or set(port) == set(ref)
    for name, (axes, shape) in port.items():
        assert (axes, shape) == ref[name], name
        for port_rules, ref_rules in RULES.values():
            for sizes, jmesh in MESHES:
                assert shd.spec_for_shape(axes, shape, sizes, port_rules) \
                    == _jspec(axes, shape, jmesh, ref_rules), name


@pytest.mark.parametrize("arch", tconfigs.ARCH_IDS)
def test_batch_structs_and_axes_are_the_reference_s(arch):
    port = build_model(tconfigs.get_config(arch), device="cpu")
    ref = jbuild_model(jconfigs.get_config(arch))
    for name, shape in tcommon.SHAPES.items():
        assert shape == tcommon.ShapeSpec(**vars(jcommon.SHAPES[name]))
        got = tcommon.batch_structs(port, shape)
        want = jcommon.batch_structs(ref, jcommon.SHAPES[name])
        assert list(got) == list(want)
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape), (name, k)
            assert str(t.dtype).split(".")[-1] == str(want[k].dtype), k
        assert tcommon.batch_axes(port, shape) == jcommon.batch_axes(
            ref, jcommon.SHAPES[name])


def test_constrain_is_identity_without_context():
    x = torch.ones((4, 4))
    assert shd.constrain(x, ("batch", "embed")) is x
