"""The port's run-time analyzer (``repro_torch.analysis``) against
``tests/test_analysis_jaxpr.py``: each rule pass catches an injected
violation with provenance in this file, a representative slice of the
real entry-point matrix is clean (the whole matrix too, with every loop
kind reading what ``LOOP_READS`` pins), and the residual bytes of the
engines keep the reference's budgets and order.

The reference's static residual bytes come from a walker local to this
test (``_reference_residual_bytes``): the reference's own
(``repro/analysis/jaxpr_walk.py``) looks for the custom-VJP primitive by
its old name ``custom_vjp_call_jaxpr``, which jax 0.9.0 calls
``custom_vjp_call``, and finds none. The local walker accepts both names,
reads ``call_jaxpr`` where ``fun_jaxpr`` is missing and calls the forward
thunk through ``call_wrapped``.
"""

import collections
import pathlib

import pytest
import torch
import torch.distributed as dist

from repro_torch.analysis import SolveConfig, analyze_config, get_config
from repro_torch.analysis.entry_points import MATRIX, process_group
from repro_torch.analysis.graph_walk import (Recorder, engine_functions,
                                             residual_info)
from repro_torch.analysis.rules import (LOOP_READS, analyze_matrix,
                                        check_collectives,
                                        check_dtype_contract,
                                        check_host_sync,
                                        check_residual_budget)
from repro_torch.core import odeint
from repro_torch.core import integrate
from repro_torch.kernels import cost_hooks
from repro_torch.launch.op_cost import OpCost

THIS_FILE = pathlib.Path(__file__).name


def _assert_provenance(finding):
    assert finding.path.endswith(THIS_FILE), finding
    assert finding.line > 0, finding


@pytest.fixture(scope="module")
def group():
    with process_group("cpu"):
        yield


# ---------------------------------------------------------------------------
# collective placement


def test_collective_inside_loop_caught(group):
    x = torch.ones(4)
    with Recorder() as rec:
        cost_hooks.loop_enter("trial")
        for _ in range(3):
            cost_hooks.trial()
            dist.all_reduce(x)
        cost_hooks.loop_exit()
    findings = check_collectives(rec, "inj")
    assert len(findings) == 1, findings
    assert findings[0].rule == "collective-in-loop"
    assert "loop depth 1" in findings[0].message
    _assert_provenance(findings[0])


def test_collective_outside_loop_allowed(group):
    x = torch.ones(4)
    with Recorder() as rec:
        dist.all_reduce(x)
    assert [e.op for e in rec.of("collective")] == ["all-reduce"]
    assert check_collectives(rec, "inj") == []


# ---------------------------------------------------------------------------
# host sync


def test_extra_host_read_in_loop_caught():
    live = torch.tensor(True)
    with Recorder() as rec:
        cost_hooks.loop_enter("trial-batched")    # pinned: 1 a trial
        bool(live)                                # the entry test
        for _ in range(2):
            cost_hooks.trial()
            bool(live)                            # the loop test
            float(live.float().sum())             # one read too many
        cost_hooks.loop_exit()
    findings = check_host_sync(rec, "inj")
    assert len(findings) == 1, findings
    assert findings[0].rule == "host-sync"
    assert "loop depth 1" in findings[0].message
    _assert_provenance(findings[0])


def test_host_read_added_to_the_trial_loop_caught(monkeypatch):
    # a host read inside adaptive_while_solve's trial loop (through the
    # step it calls each trial) breaks the loop's pin of 2 reads a trial
    rk_step = integrate.rk_step

    def reading_step(*a, **k):
        res = rk_step(*a, **k)
        float(res.z_next.sum())
        return res

    monkeypatch.setattr(integrate, "rk_step", reading_step)
    run = get_config("aca-full-solo").run("cpu")
    findings = check_host_sync(run.recorder, "aca-full-solo")
    assert len(findings) == 1, findings
    assert "'trial' loop" in findings[0].message
    _assert_provenance(findings[0])


def test_host_read_outside_listed_sites_caught():
    x = torch.ones(3)
    with Recorder() as rec:
        x.tolist()
    findings = check_host_sync(rec, "inj")
    assert len(findings) == 1 and "listed sites" in findings[0].message
    _assert_provenance(findings[0])


def test_listed_site_read_past_its_pin_caught():
    # _ts_direction reads once for ascending times and twice for
    # descending ones, its pin; a second call in the same run reads past
    # it: one finding, at that site
    from repro_torch.core import api

    with Recorder() as rec:
        api._ts_direction(torch.tensor([1.0, 0.0]))
        api._ts_direction(torch.tensor([1.0, 0.0]))
    findings = check_host_sync(rec, "inj")
    assert len(findings) == 1, findings
    assert "pinned at 2" in findings[0].message
    assert findings[0].path == "repro_torch/core/api.py"
    assert findings[0].line > 0


def test_documented_warn_site_is_allowed():
    # the real on_failure="warn" config: its one read of the status lies
    # in core/api.py outside any loop, which the pass permits
    run = get_config("aca-full-warn").run("cpu")
    outside = [(e.path, e.func) for e in run.recorder.of("read")
               if e.loop is None]
    assert ("repro_torch/core/api.py", "_failure_message") in outside
    assert analyze_config(get_config("aca-full-warn")) == []


# ---------------------------------------------------------------------------
# dtype contract


def test_float_width_cast_in_loop_caught():
    z = torch.zeros(4)
    with Recorder() as rec:
        cost_hooks.loop_enter("fixed-grid", dynamic=False)
        for _ in range(2):
            cost_hooks.trial(carry=(z,))
            wide = z.double()
            z = z + 1.0
        cost_hooks.loop_exit()
    assert wide.dtype == torch.float64
    findings = check_dtype_contract(rec, "inj")
    assert len(findings) == 1, findings
    assert findings[0].rule == "dtype-contract"
    assert "float32->float64 cast" in findings[0].message
    _assert_provenance(findings[0])


def test_carry_dtype_change_caught():
    t, t64 = torch.zeros(()), torch.zeros((), dtype=torch.float64)
    with Recorder() as rec:
        cost_hooks.loop_enter("trial")
        cost_hooks.trial(carry=(t, torch.zeros(3)))
        cost_hooks.trial(carry=(t64, torch.zeros(3)))
        cost_hooks.loop_exit()
    findings = check_dtype_contract(rec, "inj")
    assert len(findings) == 1, findings
    assert "changed dtype" in findings[0].message
    _assert_provenance(findings[0])


def test_steady_carries_pass():
    t, z = torch.zeros(()), torch.zeros(3)
    with Recorder() as rec:
        cost_hooks.loop_enter("trial")
        for _ in range(3):
            cost_hooks.trial(carry=(t, z))
            t, z = t + 0.5, z * 2.0
        cost_hooks.loop_exit()
    assert check_dtype_contract(rec, "inj") == []


# ---------------------------------------------------------------------------
# residual budget


def _fat_function(n_steps, dim):
    class Fat(torch.autograd.Function):
        @staticmethod
        def forward(ctx, z):
            # an O(n_steps * dim) residual — the bug class the gate exists
            # for
            ctx.save_for_backward(torch.zeros(n_steps, dim) + z[None, :])
            return z.clone()

        @staticmethod
        def backward(ctx, g):
            return g + ctx.saved_tensors[0][0]

    return Fat


def test_oversized_residual_caught():
    cfg = SolveConfig("inj-mali", "mali", dim=96, max_steps=64)
    fat = _fat_function(cfg.max_steps, cfg.dim)
    out = fat.apply(torch.zeros(cfg.dim, requires_grad=True))
    findings = check_residual_budget(out, cfg)
    assert len(findings) == 1, findings
    assert findings[0].rule == "residual-budget"
    assert "exceed" in findings[0].message
    _assert_provenance(findings[0])


def test_missing_engine_function_caught():
    cfg = SolveConfig("inj-missing", "aca", dim=8)
    out = torch.zeros(8, requires_grad=True) * 2
    findings = check_residual_budget(out, cfg)
    assert len(findings) == 1 and "lost sight" in findings[0].message


def test_residual_info_names_checkpoint_leaves():
    run = get_config("aca-full-solo").forward_run("cpu")
    assert len(run.residuals) == 1
    info = run.residuals[0]
    assert info.total_bytes > 0
    assert info.path == "repro_torch/core/odeint_aca.py" and info.line > 0
    # the checkpoint state buffer is a named leaf of the residuals
    names = [p for p, _ in info.named_leaves]
    assert any(p.endswith(".z") for p in names), names
    # what hides outside save_for_backward counts too: ts and the args
    assert ".ts" in names and ".arg_leaves[0]" in names


# ---------------------------------------------------------------------------
# the real matrix


@pytest.mark.parametrize(
    "name",
    ["aca-full-solo", "aca-seg-batched", "adjoint-solo", "naive-batched",
     "mali-sharded", "aca-seg-pallas-solo"],
)
def test_registered_configs_are_clean(name):
    assert analyze_config(get_config(name)) == []


def test_whole_matrix_clean_and_every_loop_kind_at_its_pin(group):
    assert len(MATRIX) == 37
    assert analyze_matrix(MATRIX) == []
    seen = collections.defaultdict(set)
    for cfg in MATRIX:
        for loop in cfg.run("cpu").recorder.loops:
            seen[loop.kind].add((loop.entry_reads, loop.max_reads))
    # each kind reads exactly what it is pinned at (its last trial may
    # read less: the loop test short-circuits on host ints)
    for kind, got in seen.items():
        entry, per_iter, _ = LOOP_READS[kind]
        assert got == {(entry, per_iter)}, (kind, got)
    # the fixed grids are not in the matrix: every solve of theirs
    # (aca, adjoint, naive on rk4) reads nothing inside its loop
    for method in ("aca", "adjoint", "naive"):
        z0 = torch.ones(3, requires_grad=True)
        with Recorder() as rec:
            ys, _ = odeint(lambda t, z: -z, z0, torch.tensor([0.0, 1.0]),
                           solver="rk4", grad_method=method,
                           steps_per_interval=4)
            ys.sum().backward()
        fixed = [L for L in rec.loops if L.kind == "fixed-grid"]
        assert fixed and all(L.entry_reads == 0 and L.max_reads == 0
                             for L in fixed), (method, rec.loops)
        assert check_host_sync(rec, method) == []


@pytest.mark.parametrize("method", ["aca", "adjoint", "naive", "mali"])
@pytest.mark.parametrize("batched", [False, True])
def test_rejecting_solves_stay_within_the_pins(method, batched):
    # the matrix's zero inputs accept every trial; a stiff random field
    # rejects some, and each trial still reads what its loop is pinned at
    gen = torch.Generator().manual_seed(0)
    w = (torch.rand(16, generator=gen) * 40.0).requires_grad_()
    z0 = torch.randn((4, 16) if batched else (16,), generator=gen)
    z0.requires_grad_()
    with Recorder() as rec:
        ys, stats = odeint(lambda t, z, w: -(w * z) + torch.sin(z), z0,
                           torch.tensor([0.0, 0.5, 1.0]), (w,),
                           grad_method=method, rtol=1e-6, atol=1e-6,
                           batch_axis=0 if batched else None)
        ys.sum().backward()
    assert bool((stats.n_trials > stats.n_steps).any()), stats
    assert check_host_sync(rec, method) == []
    assert check_dtype_contract(rec, method) == []
    assert check_collectives(rec, method) == []
    assert any(L.max_reads == LOOP_READS[L.kind][1] for L in rec.loops)


def test_recorder_leaves_the_counters_alone():
    """OpCost counts the same with a Recorder inside it as alone, the
    loops it does not count (naive, fixed grids, sweeps) leave its
    dynamic_whiles as they were, and a Recorder leaves no patch behind."""
    def solve(method, solver="dopri5"):
        z0 = torch.ones(4, requires_grad=True)
        ys, _ = odeint(lambda t, z: -z, z0, torch.tensor([0.0, 1.0]),
                       solver=solver, grad_method=method, use_pallas=True,
                       steps_per_interval=2, rtol=1e-3, atol=1e-3)
        ys.sum().backward()

    for method, whiles in (("aca", 1), ("adjoint", 2), ("naive", 0),
                           ("mali", 1)):
        with OpCost() as alone:
            solve(method, None if method == "mali" else "dopri5")
        with OpCost() as both:
            with Recorder():
                solve(method, None if method == "mali" else "dopri5")
        assert alone.dynamic_whiles == both.dynamic_whiles == whiles
        assert alone.flops == both.flops and alone.bytes == both.bytes
        assert alone.kernels == both.kernels
    with OpCost() as fixed:
        solve("aca", "rk4")
    assert fixed.dynamic_whiles == 0
    assert cost_hooks.running() == []
    assert "tolist" not in torch.Tensor.__dict__


# ---------------------------------------------------------------------------
# parity with the reference's residual bytes


REPRESENTATIVE = ["aca-full-solo", "aca-full-batched", "aca-seg-solo",
                  "aca-seg-batched", "adjoint-solo", "adjoint-batched",
                  "mali-solo", "mali-batched", "aca-full-rowtol-batched",
                  "mali-rowtol-batched", "serve-chunk", "serve-chunk-mali"]


def _reference_residual_bytes(name):
    from repro.analysis import get_config as jget_config
    from repro.analysis.jaxpr_walk import _sub_jaxprs

    def engines(jaxpr):
        jaxpr = getattr(jaxpr, "jaxpr", jaxpr)
        for eqn in jaxpr.eqns:
            if eqn.primitive.name in ("custom_vjp_call",
                                      "custom_vjp_call_jaxpr"):
                yield eqn
                continue
            for p in eqn.params.values():
                for sub in _sub_jaxprs(p):
                    yield from engines(sub)

    def nbytes(eqn):
        fun = eqn.params.get("fun_jaxpr") or eqn.params.get("call_jaxpr")
        thunk = eqn.params["fwd_jaxpr_thunk"]
        flags = [False] * (len(fun.jaxpr.invars)
                           - eqn.params.get("num_consts", 0))
        fwd, _ = getattr(thunk, "call_wrapped", thunk)(*flags)
        fwd = getattr(fwd, "jaxpr", fwd)
        avals = [v.aval for v in fwd.outvars]
        res = avals[: len(avals) - len(fun.jaxpr.outvars)]
        return sum(int(a.size) * a.dtype.itemsize for a in res)

    return sum(nbytes(e) for e in engines(jget_config(name).forward_trace()))


def test_residual_bytes_beside_the_reference(capsys):
    port, ref = {}, {}
    for name in REPRESENTATIVE:
        cfg = get_config(name)
        port[name] = cfg.forward_run("cpu").residual_bytes
        ref[name] = _reference_residual_bytes(name)
        budget = cfg.residual_budget_bytes()
        assert 0 < port[name] <= budget, (name, port[name], budget)
        assert 0 < ref[name] <= budget, (name, ref[name], budget)
    with capsys.disabled():
        for name in REPRESENTATIVE:
            print(f"\nresidual {name}: port {port[name]} reference "
                  f"{ref[name]} budget "
                  f"{get_config(name).residual_budget_bytes()}", end="")
        print()
    # the reference's order of the methods, solo and batched
    for tag in ("solo", "batched"):
        for p in (port, ref):
            assert p[f"aca-full-{tag}"] > p[f"aca-seg-{tag}"] \
                > p[f"mali-{tag}"]
            assert p[f"aca-full-{tag}"] > p[f"adjoint-{tag}"]
    # the state buffers are the reference's; the port's extra bytes are
    # what its contexts hold besides them (ts, args, status, stats)
    for name in REPRESENTATIVE:
        assert port[name] >= ref[name]
        assert port[name] - ref[name] < 4096, name


def test_engine_walk_stops_at_the_engine_and_skips_kernels():
    z0 = torch.zeros(8, 96, requires_grad=True)
    w = torch.zeros(96, requires_grad=True)
    ys, _ = odeint(lambda t, z, w: -(w * z), z0, torch.tensor([0.0, 1.0]),
                   (w,), batch_axis=0, use_pallas=True)
    nodes = engine_functions(ys)
    assert [type(n).__name__ for n in nodes] == ["_AcaSolveBatchedBackward"]
    assert residual_info(nodes[0]).total_bytes > 0
