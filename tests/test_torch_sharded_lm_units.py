"""The sharded LM's small mirrors, in one process: the MoE block's
expert/mesh divisibility error (``tests/test_validation_errors.py::
test_moe_expert_mesh_divisibility``), ``ParamDef``'s shape/axes check,
``abstract_train_state`` and ``train_state_specs`` against the
reference's (a smoke config of each family; the specs on a (data=16,
model=16) mesh of the "fake" backend), the kernel wrappers' refusal of
DTensors, a NODE stack on a mesh, and ``launch.train --mesh`` on a
one-rank gloo group against the run without it."""

import os
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils import _pytree as pytree
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs import get_smoke_config as jget_smoke
from repro.models import RunConfig as JRunConfig
from repro.models import build_model as jbuild_model
from repro.optim import adamw as jadamw
from repro.train.state import abstract_train_state as jabstract
from repro.train.state import train_state_specs as jspecs
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.node_block import NodeConfig
from repro_torch.kernels import flash_attention, rg_lru, rmsnorm, ssd_scan
from repro_torch.launch.mesh import free_port
from repro_torch.models.common import ParamDef
from repro_torch.models.config import RunConfig
from repro_torch.models.lm import build_model
from repro_torch.models.moe import moe_apply
from repro_torch.optim import adamw
from repro_torch.train.state import abstract_train_state, train_state_specs

ROOT = Path(__file__).resolve().parent.parent
FAMILIES = {"dense": "node18_cifar", "moe": "deepseek_moe_16b",
            "ssm": "mamba2_2_7b", "hybrid": "recurrentgemma_9b"}


class _JaxShapeMesh:
    """The reference's spec helpers read a mesh's ``axis_names`` and its
    ``shape`` dict only."""

    def __init__(self, shape):
        self.shape = shape
        self.axis_names = tuple(shape)


@pytest.fixture
def fake_mesh():
    """``make({name: size})``: a real ``DeviceMesh`` over a "fake"
    process group of as many ranks, in this process."""
    from torch.distributed.device_mesh import init_device_mesh

    def make(shape):
        if dist.is_initialized():
            dist.destroy_process_group()
        n = int(np.prod(list(shape.values())))
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
        return init_device_mesh("cpu", tuple(shape.values()),
                                mesh_dim_names=tuple(shape))
    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


def _leaves(tree, prefix=""):
    """{path: leaf} of nested dicts and named tuples (both packages)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for k in tree._fields:
            out.update(_leaves(getattr(tree, k), f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}


def test_moe_expert_mesh_divisibility():
    mesh = types.SimpleNamespace(mesh_dim_names=("model",), shape=(3,))
    cfg = types.SimpleNamespace(n_experts=5, top_k=2)
    rcfg = types.SimpleNamespace(compute_dtype=torch.float32, mesh=mesh,
                                 rules=None)
    p = {"router": torch.zeros((4, 5))}
    x = torch.zeros((2, 3, 4))
    with pytest.raises(ValueError, match="n_experts=5 not divisible"):
        moe_apply(p, x, cfg, rcfg)


def test_paramdef_shape_axes_mismatch_raises():
    with pytest.raises(ValueError, match="different ranks"):
        ParamDef((4, 8), torch.float32, ("embed",))
    assert ParamDef((4, 8), torch.float32).logical == (None, None)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_abstract_train_state_matches_reference(family):
    arch = FAMILIES[family]
    want = _leaves(jabstract(jbuild_model(jget_smoke(arch), JRunConfig()),
                             jadamw(1e-3)))
    got = _leaves(abstract_train_state(
        build_model(get_smoke_config(arch), RunConfig()), adamw(1e-3)))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k].shape) == tuple(w.shape), k
        assert str(got[k].dtype)[6:] == str(w.dtype), k
        assert got[k].is_meta, k


def test_abstract_train_state_allocates_nothing():
    """deepseek_moe_16b whole: 16.4 G parameters, ~200 GB of f32 state if
    it were allocated; every leaf is a meta tensor."""
    st = abstract_train_state(build_model(get_config("deepseek_moe_16b")),
                              adamw(1e-3))
    leaves = _leaves(st)
    assert all(t.is_meta for t in leaves.values())
    assert sum(t.numel() for t in leaves.values()) > 3 * 16e9


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_state_specs_match_reference(family, fake_mesh):
    arch = FAMILIES[family]
    shape = {"data": 16, "model": 16}
    want = _leaves(jspecs(jbuild_model(jget_smoke(arch), JRunConfig()),
                          jadamw(1e-3), mesh=_JaxShapeMesh(shape)))
    mesh = fake_mesh(shape)
    got = _leaves(train_state_specs(
        build_model(get_smoke_config(arch), RunConfig()), adamw(1e-3),
        mesh=mesh))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert tuple(got[k]) == tuple(w), (k, got[k], w)


def test_named_sharding_spec_tree_and_shard(fake_mesh):
    """``make_named_sharding`` and ``spec_tree_for`` against the
    reference's on a (data=2, model=4) mesh; ``shard`` without a mesh is
    the identity, with one a placement by the fitted rule."""
    from jax.sharding import PartitionSpec
    from repro.distributed import sharding as jsh
    from repro.models.transformer import block_defs as jblock_defs
    from repro_torch.distributed import sharding as tsh
    from repro_torch.models.transformer import block_defs

    shape = {"data": 2, "model": 4}
    mesh = fake_mesh(shape)
    ns = tsh.make_named_sharding(("embed", "mlp"), tsh.DEFAULT_TRAIN_RULES,
                                 mesh)
    assert ns.mesh is mesh and ns.spec == tsh.P("data", "model")
    assert ns.placements == (Shard(0), Shard(1))
    cfg = get_smoke_config("deepseek_moe_16b")
    want = jsh.spec_tree_for(jblock_defs(jget_smoke("deepseek_moe_16b"),
                                         "moe_attn", "float32"),
                             jsh.DEFAULT_TRAIN_RULES, _JaxShapeMesh(shape))
    got = tsh.spec_tree_for(block_defs(cfg, "moe_attn", torch.float32),
                            tsh.DEFAULT_TRAIN_RULES, mesh)
    flat_w = _leaves(want)
    assert all(isinstance(v, PartitionSpec) for v in flat_w.values())
    assert {k: tuple(v) for k, v in _leaves(got).items()} == \
        {k: tuple(v) for k, v in flat_w.items()}
    x = torch.arange(24.0).reshape(4, 3, 2)
    logical = ("batch", "seq", "embed_act")
    assert tsh.shard(x, logical, tsh.DEFAULT_TRAIN_RULES, None) is x
    xs = tsh.shard(x, logical, tsh.DEFAULT_TRAIN_RULES, mesh)
    assert tuple(xs.placements) == (Shard(0), Replicate())
    assert torch.equal(xs.to_local(), x[:2])


def test_kernel_wrappers_refuse_dtensors(fake_mesh):
    mesh = fake_mesh({"data": 1, "model": 1})
    rep = (Replicate(), Replicate())

    def dt(*shape):
        return DTensor.from_local(torch.ones(shape), mesh, rep)

    with pytest.raises(TypeError, match="to_local"):
        rmsnorm.rmsnorm(dt(2, 8), torch.ones(8))
    with pytest.raises(TypeError, match="to_local"):
        flash_attention.flash_attention(dt(1, 2, 4, 8), dt(1, 2, 4, 8),
                                        dt(1, 2, 4, 8))
    with pytest.raises(TypeError, match="to_local"):
        rg_lru.rg_lru(dt(1, 4, 8), dt(1, 4, 8))
    with pytest.raises(TypeError, match="to_local"):
        ssd_scan.ssd_scan(dt(1, 16, 2, 4), dt(1, 16, 2), dt(2),
                          dt(1, 16, 1, 4), dt(1, 16, 1, 4), 16)


def test_node_stack_on_mesh_raises(fake_mesh):
    """A NODE stack on ``RunConfig.mesh`` (refused until the NODE blocks
    ran per rank): on a one-rank mesh, adaptive and with ``remat``, the
    loss, every block's stats and the gradients are the mesh-less
    step's, bit for bit (every reduction over one rank is its input)."""
    from repro_torch.train.loop import _grads_of

    mesh = fake_mesh({"data": 1, "model": 1})
    cfg = get_smoke_config("node18_cifar")
    toks = torch.randint(0, cfg.vocab, (2, 8),
                         generator=torch.Generator().manual_seed(0))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    out = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)            # tiny ops: one thread is fastest
    try:
        for m_ in (None, mesh):
            m = build_model(cfg, RunConfig(
                compute_dtype=torch.float32, mesh=m_, remat="block",
                node=NodeConfig(enabled=True, use_pallas=True)))
            m.node_stats = []
            loss, _, grads = _grads_of(m, m.init(seed=0, device="cpu"),
                                       batch)
            out.append((loss, [g.full_tensor() if m_ is not None else g
                               for g in pytree.tree_leaves(grads)],
                        [tuple(int(v) for v in s)
                         for _, _, s in m.node_stats]))
    finally:
        torch.set_num_threads(threads)
    (l0, g0, s0), (l1, g1, s1) = out
    assert float(l1) == float(l0) and s1 == s0
    assert len(s1) == cfg.n_layers and all(s[1] >= 1 for s in s1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def _train(mesh: bool):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"),
                                         env.get("PYTHONPATH", "")])
    env.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "node18_cifar", "--smoke", "--steps", "10",
           "--seq", "16", "--batch", "4", "--device", "cpu"]
    r = subprocess.run(cmd + (["--mesh"] if mesh else []), env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def test_launch_train_on_a_mesh_matches_no_mesh():
    on, off = _train(True), _train(False)
    assert "mesh={'pod': 1, 'data': 1, 'model': 1}" in on
    losses = [re.findall(r"step +\d+ loss (\S+)", out) for out in (on, off)]
    assert len(losses[0]) == 1 and losses[0] == losses[1], losses
