"""The dry run's ``--node`` and ``--remat block`` train cells, one arch of
each family (dense, MoE, hybrid, SSM) at smoke size
(``launch/dryrun.py``; the flags themselves and the full-size node18
cell: ``test_torch_dryrun.py``).

* On a fake (data=2, model=4) mesh: a ``--node --remat block`` cell
  (the reference's NODE cell: its fixed rk2 ACA grid, one step here,
  under the default remat) has finite roofline terms, and the report's
  ``node_mode`` and ``remat`` say what ran.
* ``--remat block`` against ``none`` (mesh-less, at twice the smoke
  cell's sequence and batch, where saved activations set the peak): the
  block cell counts the none cell's FLOPs plus one forward of the layer
  groups (the groups' forward counted alone: a train-mode forward of the
  stack, less one with a group fewer, times the groups), within 10%, and
  holds fewer temp bytes.
"""

import dataclasses
import math

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import torch_dryrun_cells as cells
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.op_cost import OpCost
from repro_torch.models.config import RunConfig
from repro_torch.models.lm import build_model
from repro_torch.models.transformer import stack_plan

FAMILY_ARCHS = ("qwen2_72b", "deepseek_moe_16b", "recurrentgemma_9b",
                "mamba2_2_7b")
REMAT_PLAN = (64, 16, "train")

meshes = pytest.fixture(scope="module")(cells.mesh_fixture)


def _finite_terms(r) -> bool:
    roof = r["roofline"]
    return all(math.isfinite(roof[k]) and roof[k] > 0
               for k in ("flops_per_device", "bytes_per_device",
                         "t_compute", "t_memory"))


def test_family_archs_cover_every_family():
    assert {get_smoke_config(a).family for a in FAMILY_ARCHS} == {
        "dense", "moe", "hybrid", "ssm"}


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_node_and_remat_cells_on_fake_mesh(arch, meshes):
    r = dryrun.run_cell(arch, "train", mesh=meshes("2x4"),
                        config=get_smoke_config(arch),
                        plan=cells.PLANS["train"], node=True,
                        remat="block", node_steps=1, save=False)
    assert r["node_mode"] is True and r["remat"] == "block"
    assert r["mesh"] == "fake2x4" and _finite_terms(r)
    assert math.isfinite(r["roofline"]["t_collective"])


def _groups_forward_flops(cfg) -> float:
    """One forward of ``cfg``'s layer groups, mesh-less, at REMAT_PLAN."""
    seq, gb, kind = REMAT_PLAN
    unit, n_groups, _ = stack_plan(cfg)

    def forward(n):
        c = dataclasses.replace(cfg, n_layers=n * len(unit))
        model = build_model(c, RunConfig(param_dtype=torch.float32))
        fake = FakeTensorMode(allow_non_fake_inputs=True)
        dev = torch.device("cpu")
        with fake:
            params = dryrun.fake_params(model.defs, None, None, dev)
            batch = dryrun.fake_batch(dryrun._batch_abstract(
                c, kind, seq, gb), None, None, dev)
        with fake, torch.no_grad(), OpCost() as cost:
            model.forward(params, batch)
        return cost.flops

    return n_groups * (forward(n_groups) - forward(n_groups - 1))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_remat_block_counts_one_more_forward(arch):
    cfg = get_smoke_config(arch)
    none, block = (dryrun.run_cell(arch, "train", mesh="none", config=cfg,
                                   plan=REMAT_PLAN, remat=remat, save=False)
                   for remat in ("none", "block"))
    assert (none["remat"], block["remat"]) == ("none", "block")
    extra = (block["roofline"]["flops_per_device"]
             - none["roofline"]["flops_per_device"])
    want = _groups_forward_flops(cfg)
    assert abs(extra - want) <= 0.1 * want, (extra, want)
    assert block["memory_analysis"]["temp_bytes"] < \
        none["memory_analysis"]["temp_bytes"]
