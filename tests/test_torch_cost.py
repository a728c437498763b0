"""The port's cost model (``launch/op_cost.py``, ``launch/roofline.py`` and
the kernels' ``work``) against the cost tests of
``tests/test_sharding_and_cost.py`` and the reference's roofline math.

* FLOP counting: a 512² matmul exact within 5%; a Python loop over 12
  stacked weights counts every layer (12·2·256³ within 5%, the
  reference's scan trip scaling) with no dynamic loop; the gradient of a
  6-layer loop 3·6·2·128³ within 10%; an adaptive Dopri5 solve enters a
  data-dependent loop (``dynamic_whiles``) and records its first trial.
* ``active_params`` and ``model_flops`` equal the reference's exactly for
  every arch of the registry (integers and exact products).
* Collectives on a fake (2, 4) world: an all-reduce of f32[1024,16]
  counts 2·1024·16·4 bytes, an all-gather to bf16[2048] 2048·2.
* One rank: x (8, 64) sharded over ``data`` = 2 times w (64, 256) sharded
  over ``model`` = 4 counts exactly a rank's eighth of the global FLOPs.
* Each kernel wrapper under a counter records one entry of its
  ``work(...)`` and none of its plain version's ops, on CPU tensors and
  on fake CUDA tensors (which launch nothing); ``work(...)`` gives the
  bounds of ``PERF.md``'s kernel table at its shapes (to the digits the
  table shows).
* Layering: the solver core, the kernels, the models and the
  distributed layer import nothing of ``launch``; the kernels and the
  trial loops reach a counter through ``kernels/cost_hooks.py``.
"""

import ast
import math
import pathlib

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget_config
from repro.launch.roofline import active_params as j_active_params
from repro.launch.roofline import model_flops as j_model_flops
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import odeint
from repro_torch.core.tableaus import DOPRI5, HEUN_EULER
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import (cost_hooks, ops, rg_lru, rk_stage, rmsnorm,
                                ssd_scan)
from repro_torch.launch import roofline
from repro_torch.launch.op_cost import OpCost
from repro_torch.models.config import RunConfig
from repro_torch.models.lm import build_model


def _rel(got, want):
    return abs(got - want) / want


# ------------------------------------------------------------ FLOP counting
def test_matmul_exact():
    with FakeTensorMode():
        a = torch.empty(512, 512)
        with OpCost() as c:
            a @ a
    assert _rel(c.flops, 2 * 512 ** 3) < 0.05
    assert c.flops_by_dtype == {"f32": 2.0 * 512 ** 3}
    # a fake run allocates nothing, and the counter still sees the result
    assert c.peak_bytes == 512 * 512 * 4


def test_layer_loop_counts_every_layer():
    with FakeTensorMode():
        x, ws = torch.empty(256, 256), torch.empty(12, 256, 256)
        with OpCost() as c:
            for i in range(12):
                x = torch.tanh(x @ ws[i])
    want = 12 * 2 * 256 ** 3
    assert _rel(c.flops, want) < 0.05
    assert c.dynamic_whiles == 0


def test_grad_of_layer_loop():
    with FakeTensorMode():
        x = torch.empty(128, 128)
        ws = torch.empty(6, 128, 128, requires_grad=True)
        with OpCost() as c:
            y = x
            for i in range(6):
                y = torch.tanh(y @ ws[i])
            torch.autograd.grad((y ** 2).sum(), ws)
    want = 3 * 6 * 2 * 128 ** 3      # fwd + 2 bwd matmuls per layer
    assert _rel(c.flops, want) < 0.1


def test_dynamic_while_flagged():
    w = torch.tensor(np.linspace(0.5, 2.0, 8, dtype=np.float32))
    with OpCost() as c:
        _, stats = odeint(lambda t, z, w: -(w * z) + torch.tanh(z),
                          torch.ones(8), torch.tensor([0.0, 1.0]), (w,),
                          solver="dopri5", rtol=1e-6, atol=1e-6)
    assert c.dynamic_whiles >= 1
    assert int(stats.n_trials) > 1
    # the first trial's body: the K1/K2 stage work of one Dopri5 trial
    assert 0 < c.bytes_body_once < c.bytes_min


def test_no_counter_no_record():
    assert cost_hooks.active() is None
    x = torch.ones(4, 8)
    rmsnorm.rmsnorm(x, torch.ones(8))
    assert cost_hooks.active() is None


def test_counter_pushes_itself_onto_the_hooks():
    with FakeTensorMode():
        with OpCost() as outer:
            assert cost_hooks.active() is outer
            with OpCost() as inner, cost_hooks.paused():
                assert cost_hooks.active() is None
                assert cost_hooks.running() == [outer, inner]
            assert cost_hooks.active() is outer
    assert cost_hooks.running() == []


_PORT = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"


@pytest.mark.parametrize("package", ["core", "kernels", "models",
                                     "distributed"])
def test_lower_layers_import_nothing_of_launch(package):
    found = []
    for path in sorted((_PORT / package).rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom):
                names = [node.module or ""] + [
                    f"{node.module}.{a.name}" for a in node.names]
            elif isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            else:
                continue
            if any(n.startswith("repro_torch.launch") for n in names):
                found.append(f"{path.name}:{node.lineno}")
    assert found == []


# --------------------------------------------------------- roofline math
@pytest.mark.parametrize("arch", ARCHS)
def test_active_params_and_model_flops_match_reference(arch):
    assert arch in JARCHS
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert roofline.active_params(cfg) == j_active_params(jcfg)
    for kind, seq, batch in (("train", 4096, 256), ("prefill", 32768, 32),
                             ("decode", 32768, 128)):
        assert roofline.model_flops(cfg, kind, seq, batch) \
            == j_model_flops(jcfg, kind, seq, batch)


def test_active_params_moe_much_smaller_than_total():
    cfg = get_config("qwen3_moe_235b_a22b")
    total = build_model(cfg, RunConfig()).n_params()
    act = roofline.active_params(cfg)
    assert act < total / 8           # 22B active vs 235B total
    assert 15e9 < act < 30e9, act


def test_model_flops_conventions():
    cfg = get_config("musicgen_medium")
    n = roofline.active_params(cfg)
    assert roofline.model_flops(cfg, "train", 4096, 256) \
        == 6.0 * n * 4096 * 256
    assert roofline.model_flops(cfg, "prefill", 32768, 32) \
        == 2.0 * n * 32768 * 32
    assert roofline.model_flops(cfg, "decode", 32768, 128) == 2.0 * n * 128


def test_compute_time_sums_dtypes():
    r = roofline.Roofline(2e12, 0.0, 0.0, {}, 1, 1e12,
                          flops_by_dtype={"bf16": 1e12, "f32": 1e12})
    assert r.t_compute == pytest.approx(1e12 / 989e12 + 1e12 / 67e12)
    assert r.dominant == "compute"
    assert r.roofline_fraction == pytest.approx(
        (1e12 / 989e12) / r.t_compute)


# ----------------------------------------------------------- collectives
@pytest.fixture
def fake_world():
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def make(shape, names):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=math.prod(shape))
        return init_device_mesh("cpu", shape, mesh_dim_names=names)
    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


def test_collective_smoke(fake_world):
    import torch.distributed._functional_collectives as fc

    fake_world((2, 4), ("data", "model"))
    group = dist.group.WORLD               # the 8 ranks of the (2, 4) world
    with FakeTensorMode():
        with OpCost() as c:
            fc.wait_tensor(fc.all_reduce(torch.empty(1024, 16), "sum",
                                         group))
            fc.wait_tensor(fc.all_gather_tensor(
                torch.empty(256, dtype=torch.bfloat16), 0, group))
    assert c.coll["all-reduce"] == 2 * 1024 * 16 * 4
    assert c.coll["all-gather"] == 2048 * 2
    total, by_kind = roofline.collective_bytes(c.collectives())
    assert by_kind == c.coll and total == c.coll_total()
    # the records alone, as the reference's HLO smoke test gives them
    total, by_kind = roofline.collective_bytes(
        [("all-reduce", 1024 * 16 * 4, 1024 * 16 * 4),
         ("all-gather", 2048 * 2, 128 * 2)])
    assert by_kind == {"all-reduce": 2 * 1024 * 16 * 4,
                       "all-gather": 2048 * 2}


def test_sharded_matmul_counts_one_rank(fake_world):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = fake_world((2, 4), ("data", "model"))
    with FakeTensorMode():
        x = DTensor.from_local(torch.empty(4, 64), mesh,
                               (Shard(0), Replicate()), run_check=False)
        w = DTensor.from_local(torch.empty(64, 64), mesh,
                               (Replicate(), Shard(1)), run_check=False)
        assert tuple(x.shape) == (8, 64) and tuple(w.shape) == (64, 256)
        with OpCost() as c:
            y = x @ w
    assert tuple(y.shape) == (8, 256)
    assert c.flops == 2 * 8 * 64 * 256 / 8
    assert not c.coll


# ---------------------------------------------------------------- kernels
def _kernel_cases(device):
    """(name, call, work) for each wrapper at a small shape on ``device``
    (tensors made inside the caller's mode)."""
    e = torch.empty
    dopri_used = rk_stage.used_stages(DOPRI5.b, DOPRI5.b_err)
    h1 = e((), device=device)
    z1, k1 = e(64, device=device), e(7, 64, device=device)
    k2 = e(2, 64, device=device)
    zb, kb, hb = e(3, 64, device=device), e(7, 3, 64, device=device), \
        e(3, device=device)
    tol = e(3, device=device)
    x7, w7 = e(5, 32, dtype=torch.bfloat16, device=device), \
        e(32, dtype=torch.bfloat16, device=device)
    q = e(2, 4, 32, 64, device=device)
    kv = e(2, 2, 32, 64, device=device)
    x9 = e(2, 32, 4, 16, device=device)
    dt9 = e(2, 32, 4, device=device)
    a9 = e(4, device=device)
    b9 = e(2, 32, 1, 16, device=device)
    la = e(2, 8, 16, device=device)
    return [
        ("rk_stage_increment",
         lambda: rk_stage.rk_stage_increment(z1, k2, h1, HEUN_EULER.b),
         rk_stage.increment_work(1, 64, 2)),
        ("rk_stage_combine_err",
         lambda: rk_stage.rk_stage_combine_err(
             z1, k1, h1, DOPRI5.b, DOPRI5.b_err, 1e-3, 1e-3),
         rk_stage.combine_err_work(64, dopri_used)),
        ("rk_stage_combine",
         lambda: rk_stage.rk_stage_combine(z1, k1, h1, DOPRI5.b,
                                           DOPRI5.b_err),
         rk_stage.combine_work(64, dopri_used)),
        ("rk_stage_increment_batched",
         lambda: rk_stage.rk_stage_increment_batched(zb, kb, hb, DOPRI5.b),
         rk_stage.increment_work(3, 64, rk_stage.used_stages(DOPRI5.b))),
        ("rk_stage_combine_err_batched",
         lambda: rk_stage.rk_stage_combine_err_batched(
             zb, kb, hb, DOPRI5.b, DOPRI5.b_err, 1e-3, 1e-3),
         rk_stage.combine_err_batched_work(3, 64, dopri_used)),
        ("rk_stage_combine_err_batched_rowtol",
         lambda: rk_stage.rk_stage_combine_err_batched_rowtol(
             zb, kb, hb, DOPRI5.b, DOPRI5.b_err, tol, tol),
         rk_stage.combine_err_batched_work(3, 64, dopri_used,
                                           row_tol=True)),
        ("rmsnorm", lambda: rmsnorm.rmsnorm(x7, w7),
         rmsnorm.work(5, 32, 2, 2)),
        ("flash_attention", lambda: fa.flash_attention(q, kv, kv, window=8),
         fa.work(2, 4, 2, 32, 64, 8, 4)),
        ("ssd_scan", lambda: ssd_scan.ssd_scan(x9, dt9, a9, b9, b9, 16),
         ssd_scan.work(2, 32, 4, 16, 1, 16, 16, 4)),
        ("rg_lru", lambda: rg_lru.rg_lru(la, la), rg_lru.work(2 * 8 * 16)),
    ]


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("case", range(10))
def test_kernel_wrapper_counts_its_work(case, device):
    """CPU tensors take the plain version; fake CUDA tensors (no card
    needed) take no route that launches. Either way one entry of the
    kernel's work, and the plain version's own ops are not counted."""
    ops.reset_launches()
    with FakeTensorMode(allow_non_fake_inputs=True):
        name, call, (flops, nbytes) = _kernel_cases(device)[case]
        with OpCost() as c:
            out = call()
    assert c.kernels == {name: {"calls": 1, "flops": sum(flops.values()),
                                "bytes": nbytes}}
    assert c.flops_by_dtype == flops
    assert c.bytes_min == nbytes and c.bytes == nbytes
    assert not c.coll
    outs = out if isinstance(out, tuple) else (out,)
    assert all(t is None or t.device.type == device for t in outs)
    assert sum(ops.launch_counts().values()) == 0


def _bound_ms(work):
    ms, _ = roofline.kernel_bound(work)
    return ms


@pytest.mark.parametrize("name,work,want", [
    # K1 HeunEuler's stage at N = 3,145,728; K2 HeunEuler's combine
    ("K1", rk_stage.increment_work(1, 3145728, 1), 0.0113),
    ("K2", rk_stage.combine_err_work(3145728, 2, with_err=False), 0.0150),
    ("K6", rk_stage.combine_work(3145728, 2), 0.0188),
    ("K3", rk_stage.increment_work(8, 393218, 1), 0.0113),
    ("K4", rk_stage.combine_err_batched_work(8, 393216, 2), 0.0150),
    ("K5", rk_stage.combine_err_batched_work(8, 393218, 2, row_tol=True),
     0.0150),
    ("K7", rmsnorm.work(16384, 4096, 2, 2), 0.0801),
    ("K8", fa.work(4, 16, 1, 4096, 256, 2048, 2), 0.417),
    ("K9", ssd_scan.work(4, 4096, 80, 64, 1, 128, 256, 2), 0.109),
    ("K9.1", ssd_scan.chunk_state_work(4, 4096, 80, 64, 1, 128, 256, 2),
     0.105),
    ("K9.2", ssd_scan.state_pass_work(4, 16, 80, 64, 128), 0.103),
    ("K9.3", ssd_scan.chunk_scan_work(4, 4096, 80, 64, 1, 128, 256, 2),
     0.156),
    ("K10", rg_lru.work(4 * 4096 * 4096), 0.240),
])
def test_work_gives_the_perf_table_bounds(name, work, want):
    digits = len(str(want).split(".")[1])
    assert round(_bound_ms(work), digits) == want, (name, _bound_ms(work))
