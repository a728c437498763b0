"""The dry run's smoke cells on fake meshes, shared by
``test_torch_dryrun.py`` (data=2, model=4) and ``test_torch_dryrun_pods.py``
(pod=2, data=2, model=2): each arch's smoke config, each step kind, run by
``launch/dryrun.py::run_cell`` on a "fake" process group of 8 ranks in
this process, train cells with remat "none"; finite
roofline terms; ``argument_bytes`` against the bytes a rank holds by the
partition specs (``Model.specs`` / ``train_state_specs`` and the mesh
sizes alone)."""

import math

import torch
import torch.distributed as dist

from repro_torch.configs import get_smoke_config
from repro_torch.distributed.sharding import (fit_spec_to_shape,
                                              logical_to_spec, mesh_shape)
from repro_torch.launch import dryrun
from repro_torch.models.config import RunConfig
from repro_torch.models.lm import build_model
from repro_torch.optim import adamw
from repro_torch.train.state import abstract_train_state, train_state_specs

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
PLANS = {"train": (32, 8, "train"), "prefill": (32, 8, "prefill"),
         "decode": (32, 8, "decode")}


def mesh_fixture():
    made = {}

    def get(name):
        # one fake group a mesh shape; rebuilt when the shape changes or
        # a full-size cell replaced the group
        if made.get("name") != name or not dist.is_initialized() \
                or dist.get_world_size() != math.prod(MESHES[name][0]):
            made["mesh"] = dryrun.fake_mesh(*MESHES[name])
            made["name"] = name
        return made["mesh"]
    yield get
    if dist.is_initialized():
        dist.destroy_process_group()


def _finite(x):
    return isinstance(x, (int, float)) and math.isfinite(x)


def _spec_local_bytes(tree, specs, mesh):
    """Bytes of rank 0's blocks, from the specs and mesh sizes alone."""
    from torch.utils import _pytree as pytree

    sizes = mesh_shape(mesh)
    leaves = pytree.tree_leaves(tree)
    spec_leaves = pytree.tree_leaves(
        specs, is_leaf=lambda s: type(s).__name__ == "P")
    assert len(leaves) == len(spec_leaves)
    total = 0
    for t, spec in zip(leaves, spec_leaves):
        n = 1
        for d, entry in zip(t.shape, tuple(spec) + (None,) * t.dim()):
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            n *= d // math.prod(sizes[a] for a in axes)
        total += n * t.element_size()
    return total


def _batch_bytes(cfg, kind, seq, gb, mesh):
    sizes = mesh_shape(mesh)
    total = 0
    for name, (shape, dt) in dryrun._batch_abstract(cfg, kind, seq,
                                                    gb).items():
        spec = fit_spec_to_shape(shape, logical_to_spec(
            dryrun._batch_logical(name), dryrun.DEFAULT_TRAIN_RULES, mesh),
            mesh)
        n = 1
        for d, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            n *= d // math.prod(sizes[a] for a in axes)
        total += n * torch.empty((), dtype=dt).element_size()
    return total


def check_smoke_cell(arch, kind, mesh_name, mesh):
    """One smoke cell on ``mesh``: finite terms, one rank's counts and
    the argument bytes the specs imply."""
    cfg = get_smoke_config(arch)
    r = dryrun.run_cell(arch, kind, mesh=mesh, config=cfg,
                        plan=PLANS[kind], remat="none", save=False)
    roof = r["roofline"]
    for k in ("flops_per_device", "bytes_per_device",
              "coll_bytes_per_device", "t_compute", "t_memory",
              "t_collective", "model_flops_global"):
        assert _finite(roof[k]), (k, roof[k])
    assert roof["flops_per_device"] > 0 and roof["bytes_per_device"] > 0
    assert r["n_devices"] == 8 and r["mesh"] == "fake" + mesh_name
    mem = r["memory_analysis"]
    assert mem["temp_bytes"] > 0 and mem["generated_code_bytes"] is None
    seq, gb, _ = PLANS[kind]
    if kind == "decode":
        return
    model = build_model(cfg, RunConfig(
        mesh=mesh, param_dtype=torch.float32 if kind == "train"
        else torch.bfloat16))
    if kind == "train":
        opt = adamw(1e-3)
        want = _spec_local_bytes(abstract_train_state(model, opt),
                                 train_state_specs(model, opt, mesh), mesh)
    else:
        want = _spec_local_bytes(model.abstract(), model.specs(mesh), mesh)
    want += _batch_bytes(cfg, kind, seq, gb, mesh)
    assert mem["argument_bytes"] == want


