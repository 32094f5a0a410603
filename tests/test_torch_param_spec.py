"""The port's parameter layouts against the reference's sharding trees, on
the CPU with no process.

For all ten architectures, FULL and SMOKE, with and without `dp_only`:

  * `models.transformer.param_spec` equals the reference's
    `transformer.param_spec` leaf for leaf, each `PartitionSpec` as the
    port's plain tuple (after `dp_only_spec` on both sides under
    `dp_only`);
  * `launch.specs.param_shardings` on a mesh of (2, 2), (1, 4), (2, 2, 2),
    (16, 16) and (2, 16, 16) positions equals the reference's
    `_sanitize_spec` of each leaf's spec for the leaf's shape, the mesh
    given as its axis sizes.

The dry run's per-device argument bytes (`launch.dryrun.
device_args_bytes`) for yi-6b SMOKE at (2, 2) equal the hand sum of one
position's blocks: the params and, for a train step, the two f32 moments.
"""
from __future__ import annotations

import functools
import types

import jax
import pytest
from jax.sharding import PartitionSpec as P

import repro.configs as jconfigs
from repro.launch import specs as jspecs
from repro.models import transformer as jtr
from repro_torch import configs
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import transformer
from repro_torch.models.config import Runtime
from repro_torch.optim.adamw import tree_leaves

ARCHS = [c.name for c in configs.all_archs()]
MESHES = {"2x2": (2, 2), "1x4": (1, 4), "2x2x2": (2, 2, 2),
          "16x16": (16, 16), "2x16x16": (2, 16, 16)}
SIZES = ["FULL", "SMOKE"]
MODES = ["tp", "dp_only"]


def _axes(shape):
    return ("pod", "data", "model")[-len(shape):]


def _flat(tree, prefix=""):
    """{"a.b.c": leaf} of a nested dict (a `P` or a tuple is a leaf)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


@functools.lru_cache(maxsize=None)
def _reference(arch, size):
    """The reference's spec tree and abstract params, flattened."""
    jcfg = jconfigs.get(arch, smoke=size == "SMOKE")
    shapes = jax.eval_shape(lambda: jtr.init_model(jax.random.key(0), jcfg))
    return (_flat(jtr.param_spec(jcfg)),
            {k: tuple(v.shape) for k, v in _flat(shapes).items()})


@functools.lru_cache(maxsize=None)
def _abstract(arch, size):
    return specs.abstract_params(configs.get(arch, smoke=size == "SMOKE"))


def _ref_spec(spec, dp_only):
    assert isinstance(spec, P)
    return jspecs.dp_only_spec(spec) if dp_only else spec


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_is_the_references(arch, size, mode):
    dp_only = mode == "dp_only"
    want, _ = _reference(arch, size)
    got = _flat(transformer.param_spec(configs.get(
        arch, smoke=size == "SMOKE")))
    assert got.keys() == want.keys()
    for k, spec in got.items():
        assert isinstance(spec, tuple)
        if dp_only:
            spec = specs.dp_only_spec(spec)
        assert spec == tuple(_ref_spec(want[k], dp_only)), k
    # the layouts cover the port's parameters leaf for leaf
    assert got.keys() == _flat(_abstract(arch, size)).keys()


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sanitized_layouts_are_the_references(arch, size, mode, mesh):
    dp_only = mode == "dp_only"
    shape = MESHES[mesh]
    sizes = dict(zip(_axes(shape), shape))
    want_specs, shapes = _reference(arch, size)
    params = _abstract(arch, size)
    got = _flat(specs.param_shardings(
        configs.get(arch, smoke=size == "SMOKE"),
        Runtime(mesh=make_mesh(shape, _axes(shape), devices="meta"),
                dp_only=dp_only), params))
    assert got.keys() == want_specs.keys()
    fake = types.SimpleNamespace(shape=sizes)
    for k, lay in got.items():
        want = jspecs._sanitize_spec(_ref_spec(want_specs[k], dp_only),
                                     shapes[k], fake)
        assert lay == tuple(want), k


def test_a_layout_the_mesh_cannot_take_raises():
    """An axis the mesh does not have, or one named twice."""
    with pytest.raises(ValueError, match="not the axes"):
        specs.sanitize_spec(("data", "model"), (8, 8), {"data": 2})
    with pytest.raises(ValueError, match="not the axes"):
        specs.sanitize_spec(("data", ("data", "model")), (8, 8),
                            {"data": 2, "model": 2})
    # an axis that does not divide its dimension leaves it whole
    assert specs.sanitize_spec(("data", "model"), (6, 9),
                               {"data": 4, "model": 3}) == (None, "model")


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_dry_run_device_args_bytes_are_the_blocks(kind):
    cfg = configs.get("yi-6b", smoke=True)
    mesh = make_mesh((2, 2), ("data", "model"), devices="meta")
    params = tree_leaves(specs.abstract_params(cfg))
    lays = tree_leaves(specs.param_shardings(cfg, Runtime(mesh=mesh),
                                             specs.abstract_params(cfg)))
    want = 0
    for t, lay in zip(params, lays):
        n = 1
        for entry in lay:
            if entry is not None:
                for a in (entry,) if isinstance(entry, str) else entry:
                    n *= mesh.shape[a]
        per = t.element_size() + (8 if kind == "train" else 0)
        want += t.numel() // n * per
    got = dryrun.device_args_bytes(cfg, mesh, kind)
    assert got == want
    whole = sum(t.numel() * (t.element_size() + (8 if kind == "train"
                                                   else 0))
                for t in params)
    assert want < whole
