"""The dry run's smoke cells on a fake (pod=2, data=2, model=2) mesh: one
arch of each family (dense, MoE, hybrid, SSM) and one with a frontend,
each step kind (``torch_dryrun_cells.py``). Every arch is swept on the
(data=2, model=4) mesh in ``test_torch_dryrun.py``; the 3-D mesh adds the
``pod`` dim to the batch's and the state's placements, which one arch of
each family exercises."""

import pytest

import torch_dryrun_cells as cells
from repro_torch.configs import get_smoke_config

POD_ARCHS = ("qwen2_72b", "deepseek_moe_16b", "recurrentgemma_9b",
             "mamba2_2_7b", "llava_next_34b")

meshes = pytest.fixture(scope="module")(cells.mesh_fixture)


def test_pod_archs_cover_every_family():
    cfgs = [get_smoke_config(a) for a in POD_ARCHS]
    assert {c.family for c in cfgs} == {"dense", "moe", "hybrid", "ssm"}
    assert any(c.frontend != "none" for c in cfgs)


@pytest.mark.parametrize("kind", sorted(cells.PLANS))
@pytest.mark.parametrize("arch", POD_ARCHS)
def test_smoke_cells_on_fake_pod_mesh(arch, kind, meshes):
    cells.check_smoke_cell(arch, kind, "2x2x2", meshes("2x2x2"))
