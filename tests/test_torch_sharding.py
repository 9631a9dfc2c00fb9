"""The port's sharding derivation against the JAX package's.

The JAX side (``tests/torch_jax_side.py``'s ``sharding`` job) runs once,
in a subprocess with eight fake CPU devices, and hands its results over
as plain values; the port computes the same from a stand-in mesh (the
spec functions read only ``axis_names`` and ``shape``), so the
reference's 3-axis ``(pod, data, model)`` mesh is held too.  Exact
equality throughout:

* the axes tree (``zoo.init_axes``) equals the reference's ``init``
  annotations leaf for leaf, and ``zoo.abstract_params``' meta shapes and
  dtypes equal ``jax.eval_shape``'s, for all 10 archs at ``reduced()``
  and yi-6b and deepseek-moe-16b at full size (on meta);
* ``params_pspecs`` and ``adamw.state_pspecs`` (and ``state_shardings``)
  on meshes ``2x1``, ``1x2``, ``2x2`` and ``2x2x2``, FSDP on, off and
  ``"residual"``;
* ``batch_pspecs`` (``cache_pspecs`` inside it) for train, prefill and
  decode cells, batches the data axes divide and do not;
* ``logical_spec`` under the default rules and the serving overlay;
* ``quantize_int8`` / ``dequantize_int8`` bit for bit: a padded vector,
  a zero block, exact halves, a given scale that clips.
"""

import types

import numpy as np
import pytest
import torch

import torch_jax_side as side
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import keyed_specs
from repro_torch.models import zoo
from repro_torch.models.bridge import keyed_leaves
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts


@pytest.fixture(scope="module")
def jx(tmp_path_factory):
    return side.run("sharding", tmp_path_factory.mktemp("jax_sharding"))


def fake_mesh(name: str):
    shape, names = side.MESHES[name]
    return types.SimpleNamespace(axis_names=names,
                                 shape=dict(zip(names, shape)))


_ABSTRACT: dict = {}


def abstract(arch: str, size: str):
    if (arch, size) not in _ABSTRACT:
        cfg = get_config(arch)
        if size == "reduced":
            cfg = reduced(cfg)
        _ABSTRACT[(arch, size)] = (cfg,) + zoo.abstract_params(cfg)
    return _ABSTRACT[(arch, size)]


def keyed_axes(tree, prefix=""):
    if isinstance(tree, shd.Axes):
        yield prefix, tuple(tree.names)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from keyed_axes(tree[k], f"{prefix}[{k!r}]")
    else:
        for i, v in enumerate(tree):
            yield from keyed_axes(v, f"{prefix}[{i}]")


@pytest.mark.parametrize("arch,size", side.SIZES,
                         ids=[f"{a}-{s}" for a, s in side.SIZES])
def test_axes_tree_matches_jax(jx, arch, size):
    _, shapes, axes = abstract(arch, size)
    assert dict(keyed_axes(axes)) == jx["axes"][(arch, size)]
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in keyed_leaves(shapes)}
    assert got == jx["shapes"][(arch, size)]
    assert all(v.is_meta for _, v in keyed_leaves(shapes))


PSPEC_CASES = [(a, s, m, f) for a, s in side.SIZES for m in side.MESHES
               for f in side.FSDP]


@pytest.mark.parametrize("arch,size,mesh,fsdp", PSPEC_CASES,
                         ids=[f"{a}-{s}-{m}-{f}" for a, s, m, f in
                              PSPEC_CASES])
def test_params_and_state_pspecs_match_jax(jx, arch, size, mesh, fsdp):
    cfg, shapes, axes = abstract(arch, size)
    with shd.use_mesh(fake_mesh(mesh), fsdp=fsdp):
        pspecs = shd.params_pspecs(shapes, axes)
    key = (arch, size, mesh, str(fsdp))
    assert dict(keyed_specs(pspecs)) == jx["params"][key]
    assert dict(keyed_specs(adamw.state_pspecs(pspecs))) == jx["opt"][key]
    if size == "reduced":
        _, got, aopt, ospecs = ts.state_shardings(cfg, fake_mesh(mesh),
                                                  fsdp=fsdp, with_opt=True)
        assert dict(keyed_specs(got)) == jx["params"][key]
        assert dict(keyed_specs(ospecs)) == jx["opt"][key]
        assert [k for k, _ in keyed_leaves(aopt)] == list(jx["opt"][key])


BATCH_CASES = [(a, m, b[0]) for a in side.ALL_ARCHS for m in side.MESHES
               for b in side.BATCH_SHAPES]


@pytest.mark.parametrize("arch,mesh,shape", BATCH_CASES,
                         ids=[f"{a}-{m}-{s}" for a, m, s in BATCH_CASES])
def test_batch_pspecs_match_jax(jx, arch, mesh, shape):
    name, seq, batch, kind = next(b for b in side.BATCH_SHAPES
                                  if b[0] == shape)
    cfg = reduced(get_config(arch))
    specs = ts.batch_pspecs(cfg, ShapeConfig(name, seq, batch, kind),
                            fake_mesh(mesh))
    assert dict(keyed_specs(specs)) == jx["batch"][(arch, mesh, shape)]


def test_logical_spec_matches_jax(jx):
    for (mesh, rules, names), want in jx["logical"].items():
        with shd.use_mesh(fake_mesh(mesh), rules=(
                shd.SERVE_TP_RULES if rules == "serve" else None)):
            assert shd.logical_spec(*names) == want, (mesh, rules, names)
    assert shd.current_mesh() is None


@pytest.mark.parametrize("case", list(side.int8_cases()))
def test_int8_round_trip_matches_reference(jx, case):
    x = torch.from_numpy(side.int8_cases()[case])
    scale = (torch.tensor(side.GIVEN_SCALE, dtype=torch.float32)
             if case == "given_scale" else None)
    q, s, shape = collectives.quantize_int8(x, scale)
    wq, ws, wshape, wdeq = jx["int8"][case]
    assert q.dtype == torch.int8 and shape == wshape
    np.testing.assert_array_equal(q.numpy(), wq)
    np.testing.assert_array_equal(s.numpy(), ws)
    deq = collectives.dequantize_int8(q, s, shape)
    np.testing.assert_array_equal(deq.numpy(), wdeq)
    assert deq.shape == x.shape


def test_placement_slices_and_specs_round_trip():
    """``Placement.local`` cuts a leaf's data-named dim to the rank's
    share; ``keyed_specs`` gives ``keyed_leaves``' keys."""
    x = torch.arange(24.).reshape(4, 6)
    for d in range(2):
        mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                     shape={"data": 2, "model": 1},
                                     data_index=d, model_index=0)
        pl = shd.Placement(mesh, {"a": (None, "data"), "b": ("data", None),
                                  "c": ()})
        got = pl.local({"a": x, "b": x, "c": torch.tensor(1.0)})
        assert torch.equal(got["a"], x[:, 3 * d:3 * d + 3])
        assert torch.equal(got["b"], x[2 * d:2 * d + 2])
        assert got["a"].is_contiguous()
    specs = {"z": [("data",), (None,)], "a": adamw.AdamWState((), {"w": (
        None, "model")}, {"w": ("data", None)})}
    assert list(dict(keyed_specs(specs))) == [
        "['a'].step", "['a'].m['w']", "['a'].v['w']", "['z'][0]", "['z'][1]"]
