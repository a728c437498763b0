"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the reference's (``repro.distributed.sharding``): the three rule tests of
``tests/test_sharding_and_cost.py`` on both packages, the port's ``P``
against the reference's ``PartitionSpec`` entry by entry, the port's
helpers on ``DeviceMesh``es of the "fake" backend (one process, no
communication), and ``spec_to_placements``."""

import pytest
import torch.distributed as dist
from jax.sharding import PartitionSpec
from torch.distributed.tensor import Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.distributed import sharding as jsh
from repro_torch.distributed import sharding as tsh
from repro_torch.distributed.sharding import (DEFAULT_TRAIN_RULES, P,
                                              fit_spec_to_shape,
                                              logical_to_spec)


class _JaxShapeMesh:
    """The reference's helpers read only a mesh's ``axis_names`` and its
    ``shape`` dict; this stands for a JAX mesh of that shape."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


@pytest.fixture
def fake_world():
    """A "fake" process group of the given size in this process; the
    mesh built over it is a real ``DeviceMesh``."""
    def start(n):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture
def fake_mesh(fake_world):
    """``make({name: size, ...})``: a real ``DeviceMesh`` of that shape
    over a fresh "fake" world of as many ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    def make(shape):
        n = 1
        for v in shape.values():
            n *= v
        fake_world(n)
        return init_device_mesh("cpu", tuple(shape.values()),
                                mesh_dim_names=tuple(shape))
    return make


def _same(spec_t, spec_j):
    return tuple(spec_t) == tuple(spec_j)


def test_logical_to_spec_basic():
    s = logical_to_spec(("batch", "seq", "embed_act"), DEFAULT_TRAIN_RULES)
    assert s == P(("pod", "data"), None, None)
    s = logical_to_spec(("embed", "mlp"), DEFAULT_TRAIN_RULES)
    assert s == P("data", "model")


def test_rules_override():
    r = DEFAULT_TRAIN_RULES.override(mlp=None)
    assert logical_to_spec(("mlp",), r) == P(None)
    # original unchanged
    assert logical_to_spec(("mlp",), DEFAULT_TRAIN_RULES) == P("model")


def test_fit_spec_to_shape(fake_mesh):
    mesh = fake_mesh({"data": 16, "model": 16})
    # divisible: unchanged
    assert fit_spec_to_shape((152064, 5120), P("model", "data"), mesh) \
        == P("model", "data")
    # vocab not divisible -> replicated on that dim
    assert fit_spec_to_shape((50280, 2560), P("model", "data"), mesh) \
        == P(None, "data")
    # batch=1 over (pod,data) -> fully dropped
    mesh2 = fake_mesh({"pod": 2, "data": 16, "model": 16})
    assert fit_spec_to_shape((1, 32), P(("pod", "data"), None), mesh2) \
        == P(None, None)
    # partial: 32 over (pod=2, data=16) fits
    assert fit_spec_to_shape((32, 8), P(("pod", "data"), None), mesh2) \
        == P(("pod", "data"), None)
    # 2 over (pod=2, data=16): keeps pod only
    assert fit_spec_to_shape((2, 8), P(("pod", "data"), None), mesh2) \
        == P("pod", None)


def test_rule_tables_are_the_references():
    for name in ("DEFAULT_TRAIN_RULES", "DEFAULT_SERVE_RULES"):
        assert getattr(tsh, name).rules == getattr(jsh, name).rules
    assert tsh._COMMON == jsh._COMMON


@pytest.mark.parametrize("mesh_shape", [
    None, {"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
    {"model": 8}, {"data": 4}])
def test_specs_and_batch_axes_match_the_reference(mesh_shape, fake_mesh):
    """Every logical axis of the table, and every pair of them, resolves
    to the reference's spec; the batch-axis helpers give the reference's
    answers on a mesh of the same shape."""
    mesh = None if mesh_shape is None else fake_mesh(mesh_shape)
    jmesh = None if mesh_shape is None else _JaxShapeMesh(mesh_shape)
    names = [k for k, _ in DEFAULT_TRAIN_RULES.rules] + [None]
    for a in names:
        for b in names:
            st = logical_to_spec((a, b), tsh.DEFAULT_TRAIN_RULES, mesh)
            sj = jsh.logical_to_spec((a, b), jsh.DEFAULT_TRAIN_RULES, jmesh)
            assert isinstance(sj, PartitionSpec) and _same(st, sj), (a, b)
    for fn in ("data_axis_names", "batch_partition_axes",
               "batch_shard_count", "model_axis_size"):
        assert getattr(tsh, fn)(mesh) == getattr(jsh, fn)(jmesh), fn
    if mesh is not None:
        shape = (48, 50280, 5120)
        spec = P(("pod", "data"), "model", "data")
        filt = P(*(tsh._filter_axes(v, mesh) for v in spec))
        assert _same(fit_spec_to_shape(shape, filt, mesh),
                     jsh.fit_spec_to_shape(shape, PartitionSpec(*filt),
                                           jmesh))


def test_batch_axes_on_device_meshes(fake_world):
    """The helpers read a ``DeviceMesh``'s dim names and sizes: a (pod=2,
    data=4, model=4) mesh of 32 fake ranks shards the batch 8-way over
    (pod, data); rules mapping 'batch' to 'model' shard it over model."""
    from torch.distributed.device_mesh import init_device_mesh

    fake_world(32)
    mesh = init_device_mesh("cpu", (2, 4, 4),
                            mesh_dim_names=("pod", "data", "model"))
    assert tsh.mesh_shape(mesh) == {"pod": 2, "data": 4, "model": 4}
    assert tsh.data_axis_names(mesh) == ("pod", "data")
    assert tsh.batch_partition_axes(mesh) == ("pod", "data")
    assert tsh.batch_shard_count(mesh) == 8
    assert tsh.model_axis_size(mesh) == 4
    rules = DEFAULT_TRAIN_RULES.override(batch="model")
    assert tsh.batch_partition_axes(mesh, rules) == ("model",)
    assert tsh.batch_shard_count(mesh, rules) == 4
    assert tsh.logical_to_spec(("batch", "embed", "mlp"), DEFAULT_TRAIN_RULES,
                               mesh) == P(("pod", "data"), "data", "model")


def test_spec_to_placements(fake_world):
    from torch.distributed.device_mesh import init_device_mesh

    fake_world(32)
    mesh = init_device_mesh("cpu", (2, 4, 4),
                            mesh_dim_names=("pod", "data", "model"))
    assert tsh.spec_to_placements(P("model", "data"), mesh) == (
        Replicate(), Shard(1), Shard(0))
    assert tsh.spec_to_placements(P(("pod", "data"), None), mesh) == (
        Shard(0), Shard(0), Replicate())
    assert tsh.spec_to_placements(P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="does not have"):
        tsh.spec_to_placements(P("expert"), mesh)
    with pytest.raises(ValueError, match="twice"):
        tsh.spec_to_placements(P("data", "data"), mesh)
    with pytest.raises(ValueError, match="out of the mesh's order"):
        tsh.spec_to_placements(P(("data", "pod")), mesh)


def test_shard_mesh_needs_a_process_group():
    from repro_torch.distributed import NoProcessGroupError

    assert not dist.is_initialized()
    with pytest.raises(NoProcessGroupError, match="process group"):
        tsh.shard_mesh("cpu")


def test_shard_mesh_is_flat_over_the_world(fake_world):
    fake_world(8)
    mesh = tsh.shard_mesh("cpu")
    assert mesh.mesh_dim_names == ("data",)
    assert tsh.batch_shard_count(mesh) == 8
