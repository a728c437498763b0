"""The port's production dry run (``launch/dryrun.py``) and its report.

* ``main`` without ``--arch``/``--shape`` or ``--all`` raises the
  reference's ValueError (``tests/test_sharding_and_cost.py`` has no such
  test; the reference's message is kept word for word).
* ``--node`` and ``--remat block`` (refused until the port ran NODE
  blocks on a mesh and had ``remat``) build their cells, and the report
  carries them (``node_mode``, ``remat``); ``--node-steps`` sets the
  NODE grid. One full-size cell: node18_cifar × train_4k ``--node`` on
  pod16x16 through ``main`` (about 25 s on a CPU). Each family's
  ``--node`` and ``--remat block`` cells: ``test_torch_dryrun_node_remat
  .py``.
* Every arch's smoke config, each step kind (train, prefill, decode),
  on a fake (data=2, model=4) mesh (``torch_dryrun_cells.py``; the
  (pod=2, data=2, model=2) cells in ``test_torch_dryrun_pods.py``):
  finite roofline terms, one rank's counts, and ``argument_bytes`` equal
  to the bytes a rank holds by the partition specs.
* Mesh-less smoke prefill and train cells: the matmul-class FLOPs the
  port counts sit within 5% of the reference's ``analyze_hlo`` FLOPs of
  the same cell, jitted (remat "none" on both sides; the reference
  counts dots only).
  The port's prefill runs the LM head on the last position alone
  (``models/lm.py::Model.prefill``), the reference's on every position
  before it slices: that product, 2·B·(S-1)·D·V, is taken off the
  reference's count.
* Heads that a mesh dim does not divide stay whole (qwen1_5_32b's 40 on
  a 16-way ``model`` dim, at smoke size).
* One full-size cell: deepseek_moe_16b × decode_32k on pod16x16 (about
  20 s on a CPU).
"""

import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import pytest
import torch.distributed as dist

import torch_dryrun_cells as cells

from repro.configs import get_smoke_config as jget_smoke
from repro.launch.hlo_cost import analyze_hlo
from repro.models import RunConfig as JRunConfig
from repro.models import build_model as jbuild_model
from repro.optim import adamw as jadamw
from repro.optim import cosine_warmup as jcosine
from repro.optim.grad_utils import CompressionState as JComp
from repro.train.loop import TrainLoopConfig as JLoopConfig
from repro.train.loop import build_train_step as jbuild_step
from repro.train.state import abstract_train_state as jabstract_state
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.launch import dryrun

MESHES, PLANS = cells.MESHES, cells.PLANS
meshes = pytest.fixture(scope="module")(cells.mesh_fixture)


def test_dryrun_requires_arch_and_shape():
    with pytest.raises(ValueError, match="pass --arch and --shape"):
        dryrun.main([])


@pytest.mark.parametrize("flag", [["--node"], ["--remat", "block"]])
def test_unported_options_raise(flag, meshes):
    """The two options the port once refused now build their cells (a
    smoke train cell of deepseek_moe_16b on the fake (2, 4) mesh), and
    the report says which; other kinds run without remat."""
    node = flag == ["--node"]
    remat = "block" if "block" in flag else "none"
    r = dryrun.run_cell("deepseek_moe_16b", "train", mesh=meshes("2x4"),
                        config=get_smoke_config("deepseek_moe_16b"),
                        plan=PLANS["train"], node=node, remat=remat,
                        node_steps=1, save=False)
    assert r["node_mode"] is node and r["remat"] == remat
    assert r["roofline"]["flops_per_device"] > 0
    cell = dryrun.build_cell("deepseek_moe_16b", "decode_32k", None,
                             node=node, remat=remat,
                             config=get_smoke_config("deepseek_moe_16b"),
                             plan=PLANS["decode"])
    assert cell.remat == "none"


def test_node_steps_flag_raises(tmp_path, monkeypatch):
    """``--node`` with ``--node-steps`` through ``main``: the full-size
    node18_cifar × train_4k cell on pod16x16 (``--remat`` at its default,
    ``block``), saved under ``__node``, its terms finite; the steps reach
    the cell's NodeConfig."""
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    try:
        dryrun.main(["--arch", "node18_cifar", "--shape", "train_4k",
                     "--node", "--node-steps", "1"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(tmp_path / "pod16x16" / "node18_cifar__train_4k__node.json") \
            as fh:
        r = json.load(fh)
    assert r["node_mode"] is True and r["remat"] == "block"
    assert r["mesh"] == "pod16x16" and r["n_devices"] == 256
    roof = r["roofline"]
    assert all(math.isfinite(roof[k]) and roof[k] > 0
               for k in ("t_compute", "t_memory", "t_collective"))
    ncfg = dryrun.node_config(True, 1)
    assert (ncfg.regime, ncfg.grad_method, ncfg.solver,
            ncfg.steps_per_interval) == ("fixed", "aca", "rk2", 1)


@pytest.mark.parametrize("kind", sorted(PLANS))
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_cells_on_fake_mesh(arch, kind, meshes):
    cells.check_smoke_cell(arch, kind, "2x4", meshes("2x4"))


@pytest.mark.parametrize("kind", sorted(PLANS))
def test_heads_that_do_not_divide_the_model_dim(kind, meshes):
    """qwen1_5_32b's 40 heads on pod16x16's 16-way ``model`` dim, at
    smoke size: 6 heads of 16 on ``model`` = 4 (96 projection columns
    divide 4, the heads do not). The heads stay whole, replicated over
    ``model`` (``models/attention.py::_place_heads``), and the cell
    runs."""
    cfg = dataclasses.replace(get_smoke_config("qwen1_5_32b"), n_heads=6,
                              n_kv_heads=6, head_dim=16)
    r = dryrun.run_cell("qwen1_5_32b", kind, mesh=meshes("2x4"), config=cfg,
                        plan=PLANS[kind], remat="none", save=False)
    assert r["roofline"]["flops_per_device"] > 0


def _reference_flops(arch, kind, seq, gb):
    cfg = jget_smoke(arch)
    model = jbuild_model(cfg, JRunConfig(
        compute_dtype=jnp.bfloat16, remat="none",
        param_dtype=jnp.float32 if kind == "train" else jnp.bfloat16))
    batch = {k: jax.ShapeDtypeStruct(s, jnp.dtype(str(dt)[6:]))
             for k, (s, dt) in dryrun._batch_abstract(cfg, kind, seq,
                                                      gb).items()}
    if kind == "train":
        opt = jadamw(jcosine(3e-4, 100, 10000), weight_decay=0.1)
        step = jbuild_step(model, opt, JLoopConfig(clip_norm=1.0))
        args = (jabstract_state(model, opt), batch, JComp(error=()))
        fn = step
    else:
        fn, args = model.prefill, (model.abstract(), batch)
    hlo = jax.jit(fn).lower(*args).compile().as_text()
    flops = analyze_hlo(hlo).flops
    if kind == "prefill":
        # the reference's head runs on every position, the port's on the
        # last one only
        flops -= 2.0 * gb * (seq - 1) * cfg.d_model * cfg.vocab
    return flops


@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("arch", ["qwen1_5_32b", "deepseek_moe_16b",
                                  "mamba2_2_7b", "recurrentgemma_9b",
                                  "llava_next_34b", "musicgen_medium"])
def test_meshless_flops_match_reference(arch, kind):
    seq, gb, _ = PLANS[kind]
    r = dryrun.run_cell(arch, kind, mesh="none", config=get_smoke_config(
        arch), plan=PLANS[kind], remat="none", save=False)
    got = r["roofline"]["flops_per_device"]
    want = _reference_flops(arch, kind, seq, gb)
    assert abs(got - want) / want < 0.05, (got, want)


def test_full_size_decode_cell_on_pod16x16():
    try:
        r = dryrun.run_cell("deepseek_moe_16b", "decode_32k", save=False)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert r["mesh"] == "pod16x16" and r["n_devices"] == 256
    roof = r["roofline"]
    assert all(math.isfinite(roof[k]) for k in ("t_compute", "t_memory",
                                                "t_collective"))
    assert r["memory_analysis"]["argument_bytes"] < 8e9   # one rank's share
