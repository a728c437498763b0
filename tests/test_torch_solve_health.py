"""Solve health on the port, mirroring ``tests/test_solve_health.py``:
status codes, the non-finite guards, freezing, cotangent masking, the
``on_failure`` policies, ``odeint_checked`` and the fallback ladder, for
the four gradient methods (mali included), solo and batched, on the plain
and the fused path (the kernels' plain versions on the CPU).

The reference's three train-loop tests wait for slice G4 (ROADMAP queue
1, item 6) and its three ``serve_generate`` eos tests are mirrored in
``tests/test_torch_lm_serve.py``. Faults come from ``tests/torch_faults.py``,
the torch port of ``tests/faults.py``. Where a test's outcome is a
status, a report or a frozen output, the reference computes it on the
same inputs and the port must give the same codes, the same rungs and
the same landings; values are held to rtol=1e-5, atol=1e-6 (the solve
parity bound of ``tests/test_torch_solve.py``), bitwise only between two
paths of the port, where the reference pins the same pair of its own.
The guards cost check (``repro_torch.benchmarks.failure_overhead``) runs
at its quick size, its 5% gate held on given numbers.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from faults import faulty_field as jfaulty
from repro.core import SolveStatus as JStatus
from repro.core import odeint as jodeint
from repro.core import solve_with_fallback as jfallback
from repro.kernels import ops as jops
from repro_torch.core import (
    ControllerConfig,
    SolveFailedError,
    SolveStatus,
    adaptive_while_solve,
    batched_adaptive_while_solve,
    mali_adaptive_solve,
    odeint,
    odeint_checked,
    solve_with_fallback,
)
from repro_torch.core.tableaus import get_tableau
from torch_faults import faulty_field

METHODS = ("aca", "adjoint", "naive", "mali")
TOL = dict(rtol=1e-3, atol=1e-3)      # keeps mali inside its step budget
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _interpret_kernels():
    jops.set_interpret(True)
    yield
    jops.set_interpret(None)


def _kw(method, **extra):
    kw = dict(TOL, grad_method=method, **extra)
    if method != "mali":
        kw["solver"] = "dopri5"
    return kw


def _decay(t, z):
    return -z


def _bits_equal(a, b):
    return torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def _ref(f, z0, ts, **kw):
    ys, st = jodeint(f, jnp.asarray(z0), jnp.asarray(ts), **kw)
    return np.asarray(ys), np.asarray(st.n_steps), np.asarray(st.status)


# ------------------------------------------------------------------ status
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("batched", [False, True])
def test_clean_solve_status_ok(method, batched):
    z0 = np.ones((3, 4) if batched else (4,), np.float32)
    ts = np.linspace(0.0, 1.0, 4, dtype=np.float32)
    kw = _kw(method, batch_axis=0) if batched else _kw(method)
    ys, st = odeint(_decay, torch.tensor(z0), torch.tensor(ts), **kw)
    assert bool((st.status == SolveStatus.OK).all()), st.status
    assert bool(torch.isfinite(ys).all())
    ys_r, n_r, _ = _ref(_decay, z0, ts, **kw)
    np.testing.assert_array_equal(st.n_steps.numpy(), n_r)
    np.testing.assert_allclose(ys.numpy(), ys_r, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_nan_fault_detected_and_frozen(method, batched, use_pallas):
    """Mid-solve NaN: NONFINITE_STATE, finite outputs, the pre-fault eval
    prefix bitwise the unfaulted solve's, the post-fault slots the frozen
    last accepted state; the frozen outputs within the parity bound of
    the reference's."""
    z0 = np.ones((3, 4) if batched else (4,), np.float32)
    ts = np.linspace(0.0, 1.0, 5, dtype=np.float32)
    t_fault = 0.45
    kw = _kw(method, use_pallas=use_pallas)
    if batched:
        kw["batch_axis"] = 0
    zt, tt = torch.tensor(z0), torch.tensor(ts)
    ys_ok, _ = odeint(_decay, zt, tt, **kw)
    ys, st = odeint(faulty_field(_decay, "nan", t_ge=t_fault), zt, tt, **kw)
    assert bool((st.status == SolveStatus.NONFINITE_STATE).all()), st.status
    assert bool(torch.isfinite(ys).all())
    n_pre = int((ts < t_fault).sum())
    assert _bits_equal(ys[:n_pre], ys_ok[:n_pre])
    for k in range(n_pre + 1, ts.shape[0]):
        assert _bits_equal(ys[k], ys[n_pre])
    if not use_pallas:
        ys_r, _, s_r = _ref(jfaulty(_decay, "nan", t_ge=t_fault), z0, ts,
                            **kw)
        np.testing.assert_array_equal(st.status.numpy(), s_r)
        np.testing.assert_allclose(ys.numpy(), ys_r, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kind", ["nan", "inf", "spike"])
def test_fault_kinds_all_unhealthy(kind):
    """Every injector kind ends unhealthy: NaN and Inf as NONFINITE_STATE,
    the finite spike through the error test; the code is the
    reference's."""
    z0 = np.ones(4, np.float32)
    ts = np.linspace(0.0, 1.0, 4, dtype=np.float32)
    ys, st = odeint(faulty_field(_decay, kind, t_ge=0.45), torch.tensor(z0),
                    torch.tensor(ts), **_kw("aca"))
    assert int(st.status) != SolveStatus.OK
    if kind in ("nan", "inf"):
        assert int(st.status) == SolveStatus.NONFINITE_STATE
    assert bool(torch.isfinite(ys).all())
    _, _, s_r = _ref(jfaulty(_decay, kind, t_ge=0.45), z0, ts, **_kw("aca"))
    assert int(st.status) == int(s_r)


def test_status_underflow_budget_overflow():
    """The three degradation codes, as the reference gives them: a jump
    rails h at h_min while failing the error test (UNDERFLOW), a 1-trial
    budget runs out (BUDGET), a tight tolerance with a tiny step cap runs
    out of checkpoints (OVERFLOW)."""
    z0 = torch.ones(2)
    ts = torch.linspace(0.0, 1.0, 3)

    def fjump(t, z):
        return torch.where(t < 0.5, 1.0, -1e6) * torch.ones_like(z)

    _, st = odeint(fjump, z0, ts, rtol=1e-6, atol=1e-9, max_steps=256)
    assert int(st.status) == SolveStatus.STEPSIZE_UNDERFLOW

    _, st = odeint(lambda t, z: -1e5 * z, z0, ts, rtol=1e-12, atol=1e-14,
                   max_steps=64, max_trials=1)
    assert int(st.status) == SolveStatus.TRIAL_BUDGET_EXHAUSTED

    _, st = odeint(_decay, z0, ts, rtol=1e-12, atol=1e-14, max_steps=8)
    assert int(st.status) == SolveStatus.CHECKPOINT_OVERFLOW
    for name in ("STEPSIZE_UNDERFLOW", "TRIAL_BUDGET_EXHAUSTED",
                 "CHECKPOINT_OVERFLOW", "NONFINITE_STATE", "OK"):
        assert getattr(SolveStatus, name) == getattr(JStatus, name)


def test_status_describe():
    assert SolveStatus.describe(SolveStatus.OK) == "OK"
    assert SolveStatus.describe(
        SolveStatus.NONFINITE_STATE) == "NONFINITE_STATE"
    for code in range(5):
        assert "UNKNOWN" not in SolveStatus.describe(code)
        assert SolveStatus.describe(code) == JStatus.describe(code)
    assert "UNKNOWN" in SolveStatus.describe(99)


# ------------------------------------------------- batched isolation/grads
def _tag_field(t, z):
    return torch.stack([-z[0], 0.0 * z[1]])


def _tag_field_j(t, z):
    return jnp.stack([-z[0], 0.0 * z[1]])


@pytest.mark.parametrize("method", METHODS)
def test_batched_single_element_fault_isolated(method):
    """One poisoned batch row: its status flips, the other rows are bitwise
    the unfaulted batch, and (aca, adjoint, mali) the gradients are finite
    with the failed row's dz0 exactly zero; statuses are the
    reference's."""
    z0 = np.array([[1.0, 0.0], [1.0, 1.0], [1.0, 2.0]], np.float32)
    ts = np.linspace(0.0, 1.0, 4, dtype=np.float32)

    def pred(t, z):  # tolerant tag match: MALI's lattice moves the tag
        return torch.abs(z[1] - 1.0) < 0.5

    fbad = faulty_field(_tag_field, "nan", t_ge=0.45, predicate=pred)
    kw = _kw(method, batch_axis=0)
    tt = torch.tensor(ts)
    ys_ok, _ = odeint(_tag_field, torch.tensor(z0), tt, **kw)
    ys, st = odeint(fbad, torch.tensor(z0), tt, **kw)
    assert st.status.tolist() == [SolveStatus.OK,
                                  SolveStatus.NONFINITE_STATE,
                                  SolveStatus.OK]
    assert bool(torch.isfinite(ys).all())
    assert _bits_equal(ys[:, 0], ys_ok[:, 0])
    assert _bits_equal(ys[:, 2], ys_ok[:, 2])
    _, _, s_r = _ref(jfaulty(_tag_field_j, "nan", t_ge=0.45,
                             predicate=lambda t, z: jnp.abs(z[1] - 1.0)
                             < 0.5), z0, ts, **kw)
    assert st.status.tolist() == s_r.tolist()
    if method == "naive":
        # the naive method keeps the faulted trial on its tape: its
        # gradient need not be finite (as the reference's)
        return
    zg = torch.tensor(z0, requires_grad=True)
    ys, _ = odeint(fbad, zg, tt, **kw)
    torch.sum(ys[-1, :, 0] ** 2).backward()
    g = zg.grad
    assert bool(torch.isfinite(g).all()), g
    assert _bits_equal(g[1], torch.zeros_like(g[1]))
    assert float(g[0].abs().max()) > 0.0


# -------------------------------------------------- default-path identity
def test_guards_are_bitwise_noop_on_healthy_solve():
    """guard_nonfinite True against False on a healthy solve: the same
    trajectories and counters bit for bit, solo, batched and on the MALI
    engine."""
    tab = get_tableau("dopri5")
    cfg = ControllerConfig()
    z0 = torch.ones(4)
    ts = torch.linspace(0.0, 1.0, 4)
    runs = [adaptive_while_solve(tab, _decay, z0, ts, (), 1e-6, 1e-6, cfg,
                                 guard_nonfinite=g) for g in (True, False)]
    (ys_g, _, st_g), (ys_n, _, st_n) = runs
    assert _bits_equal(ys_g, ys_n)
    assert int(st_g.n_steps) == int(st_n.n_steps)
    assert int(st_g.n_trials) == int(st_n.n_trials)
    assert int(st_g.status) == SolveStatus.OK

    z0b = torch.ones(3, 4)
    runs = [batched_adaptive_while_solve(tab, _decay, z0b, ts, (), 1e-6,
                                         1e-6, cfg, guard_nonfinite=g)
            for g in (True, False)]
    (ys_g, _, st_g), (ys_n, _, st_n) = runs
    assert _bits_equal(ys_g, ys_n)
    assert _bits_equal(st_g.n_trials, st_n.n_trials)

    runs = [mali_adaptive_solve(_decay, z0, ts, (), 1e-3, 1e-3, cfg,
                                guard_nonfinite=g) for g in (True, False)]
    (ys_g, _, st_g), (ys_n, _, st_n) = runs
    assert _bits_equal(ys_g, ys_n)
    assert int(st_g.n_trials) == int(st_n.n_trials)


# ------------------------------------------------------------- policies
def test_on_failure_validation():
    z0, ts = torch.ones(2), torch.linspace(0.0, 1.0, 3)
    with pytest.raises(ValueError, match="on_failure"):
        odeint(_decay, z0, ts, on_failure="explode")
    with pytest.raises(ValueError, match="h0"):
        odeint(_decay, z0, ts, solver="rk4", h0=0.1)
    # validation comes before any work: a field that raises is never
    # called
    def boom(t, z):
        raise AssertionError("the field ran")

    with pytest.raises(ValueError, match="on_failure"):
        odeint(boom, z0, ts, on_failure="explode")


def test_on_failure_warn_smoke():
    """"warn" warns naming the codes on a failed solve and returns what
    "status" returns; a healthy solve does not warn and keeps its bits."""
    z0, ts = torch.ones(2), torch.linspace(0.0, 1.0, 3)
    fbad = faulty_field(_decay, "nan", t_ge=0.45)
    with pytest.warns(RuntimeWarning, match="NONFINITE_STATE"):
        ys, st = odeint(fbad, z0, ts, on_failure="warn", **_kw("aca"))
    assert int(st.status) == SolveStatus.NONFINITE_STATE
    ys_s, _ = odeint(fbad, z0, ts, **_kw("aca"))
    assert _bits_equal(ys, ys_s)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        ys, st = odeint(_decay, z0, ts, on_failure="warn", **_kw("aca"))
    assert int(st.status) == SolveStatus.OK
    assert _bits_equal(ys, odeint(_decay, z0, ts, **_kw("aca"))[0])


def test_odeint_checked_raises_on_fault():
    """The reference raises ``checkify.JaxRuntimeError``; the port raises
    ``SolveFailedError`` with the same "status" text, solo and on a batch
    with one failed row."""
    z0, ts = torch.ones(2), torch.linspace(0.0, 1.0, 3)
    ys, st = odeint_checked(_decay, z0, ts, **_kw("aca"))
    assert int(st.status) == SolveStatus.OK
    fbad = faulty_field(_decay, "nan", t_ge=0.45)
    with pytest.raises(SolveFailedError, match="status"):
        odeint_checked(fbad, z0, ts, **_kw("aca"))
    assert issubclass(SolveFailedError, RuntimeError)
    with pytest.raises(SolveFailedError, match="NONFINITE_STATE"):
        odeint(faulty_field(_tag_field, "nan", t_ge=0.45,
                            predicate=lambda t, z: z[1] > 0.5),
               torch.tensor([[1.0, 0.0], [1.0, 1.0]]), ts,
               on_failure="raise", **_kw("mali", batch_axis=0))


@pytest.mark.parametrize("policy", ["status", "warn", "raise"])
def test_node_config_threads_on_failure(policy):
    from repro_torch.core import NodeConfig, node_block_apply

    cfg = NodeConfig(enabled=True, on_failure=policy)
    params = {"w": torch.ones(3) * 0.1}

    def block(p, z, t):
        return -p["w"] * z

    zT = node_block_apply(block, params, torch.ones(3), cfg)
    assert bool(torch.isfinite(zT).all())
    if policy == "raise":
        fbad = faulty_field(lambda t, z, p: block(p, z, t), "nan",
                            t_ge=0.45)
        with pytest.raises(SolveFailedError, match="status"):
            node_block_apply(lambda p, z, t: fbad(t, z, p), params,
                             torch.ones(3), cfg)


# ------------------------------------------------------------- fallback
def _report_summary(report):
    return [(r["note"], r["ok"]) for r in report]


def test_solve_with_fallback_recovers():
    """A tight tolerance with a tiny step cap fails; the ladder walks the
    reference's rungs with the reference's outcomes and recovers on the
    fixed rk4 grid."""
    z0, ts = np.ones(2, np.float32), np.linspace(0.0, 1.0, 3,
                                                  dtype=np.float32)
    kw = dict(rtol=1e-12, atol=1e-14, max_steps=8)
    ys, st, report = solve_with_fallback(_decay, torch.tensor(z0),
                                         torch.tensor(ts), **kw)
    assert bool((st.status == SolveStatus.OK).all())
    assert bool(torch.isfinite(ys).all())
    assert report[0]["ok"] is False and report[-1]["ok"] is True
    assert any("rk4" in r["note"] for r in report)
    np.testing.assert_allclose(ys[-1].numpy(), np.exp(-1.0) * np.ones(2),
                               rtol=1e-4)
    ys_r, _, report_r = jfallback(_decay, jnp.asarray(z0), jnp.asarray(ts),
                                  **kw)
    assert _report_summary(report) == _report_summary(report_r)
    assert [r.get("status") for r in report] == \
        [r.get("status") for r in report_r]
    np.testing.assert_allclose(ys.numpy(), np.asarray(ys_r), rtol=RTOL,
                               atol=ATOL)


def test_solve_with_fallback_healthy_short_circuits():
    z0, ts = torch.ones(2), torch.linspace(0.0, 1.0, 3)
    ys, st, report = solve_with_fallback(_decay, z0, ts, **_kw("aca"))
    assert len(report) == 1 and report[0]["note"] == "original"
    assert report[0]["ok"] is True
    assert _bits_equal(ys, odeint(_decay, z0, ts, **_kw("aca"))[0])


def test_solve_with_fallback_unrecoverable_returns_frozen():
    z0, ts = np.ones(2, np.float32), np.linspace(0.0, 1.0, 3,
                                                  dtype=np.float32)
    fbad = faulty_field(_decay, "nan", t_ge=0.45)
    ys, st, report = solve_with_fallback(fbad, torch.tensor(z0),
                                         torch.tensor(ts), **_kw("aca"))
    assert all(not r.get("ok") for r in report)
    assert int(st.status) == SolveStatus.NONFINITE_STATE
    assert bool(torch.isfinite(ys).all())            # frozen, not garbage
    _, _, report_r = jfallback(jfaulty(_decay, "nan", t_ge=0.45),
                               jnp.asarray(z0), jnp.asarray(ts),
                               **_kw("aca"))
    assert _report_summary(report) == _report_summary(report_r)


def test_solve_with_fallback_every_rung_raising():
    """When every attempt raises, the ladder raises ``RuntimeError``
    carrying the report."""
    def broken(t, z):
        raise FloatingPointError("field broke")

    with pytest.raises(RuntimeError, match="every attempt errored"):
        solve_with_fallback(broken, torch.ones(2),
                            torch.linspace(0.0, 1.0, 3))


# ------------------------------------------------- the guards' cost gate
def test_failure_overhead_bench_quick(monkeypatch):
    """``repro_torch.benchmarks.failure_overhead`` at its quick size (the
    reference's van der Pol problem, 2 interleaved pairs here): the
    guarded and the bare solve take equal trials, the guard's work lies in
    ``trial_decision`` and the initial check (``guard_ops`` gates the op
    counts: a guarded solve's extra ops are n_trials × the decision's + the
    check's, and a stray check fails it), and the overhead is the guard's parts' time over the bare
    solve's. The 5% gate is then held on given numbers: 4% passes, 6%
    raises ``GateFailed``, and a bare solve under the reference's 1 ms
    noise floor skips. On the card chip_smoke applies the gate to the
    quick mode's measured numbers."""
    from repro_torch.benchmarks import failure_overhead
    from repro_torch.benchmarks.common import GateFailed

    m = failure_overhead.measure(quick=True, device="cpu", reps=2)
    assert m["trials"] > 1000
    assert m["reps"] == 2
    ops = m["ops"]
    assert ops["decision_extra"] > 0 and ops["initial"] > 0
    assert ops["solve_extra"] == (ops["n_trials"] * ops["decision_extra"]
                                  + ops["initial"])
    assert m["decision_extra_us"] > 0 and m["initial_check_us"] > 0
    assert 0 < m["bare_s"] and 0 < m["guarded_s"]
    assert m["guard_s"] == pytest.approx(
        m["trials"] * m["decision_extra_us"] * 1e-6
        + m["initial_check_us"] * 1e-6)
    assert m["overhead_frac"] == m["guard_s"] / m["bare_s"]
    # a guard that does work outside its parts fails the count
    solve = failure_overhead.solve

    def solve_with_stray_check(z0, ts, mu, guard):
        if guard:
            torch.isfinite(z0).all()
        return solve(z0, ts, mu, guard)

    monkeypatch.setattr(failure_overhead, "solve", solve_with_stray_check)
    with pytest.raises(GateFailed, match="outside trial_decision"):
        failure_overhead.guard_ops(torch.device("cpu"))
    monkeypatch.setattr(failure_overhead, "solve", solve)

    def given(frac, bare_s):
        return lambda *a, **k: {**m, "bare_s": bare_s,
                                "guard_s": bare_s * frac,
                                "overhead_frac": frac}

    monkeypatch.setattr(failure_overhead, "measure", given(0.04, 1.0))
    out = failure_overhead.run(quick=True, device="cpu")
    assert set(out) == {"failure_overhead/trials",
                        "failure_overhead/guarded_s",
                        "failure_overhead/bare_s", "failure_overhead/frac",
                        "failure_overhead/gate"}
    assert out["failure_overhead/gate"] == "PASS"
    monkeypatch.setattr(failure_overhead, "measure", given(0.06, 1.0))
    with pytest.raises(GateFailed, match="cost 6.0% of the solve"):
        failure_overhead.run(quick=True, device="cpu")
    monkeypatch.setattr(failure_overhead, "measure", given(0.5, 1e-4))
    out = failure_overhead.run(quick=True, device="cpu")
    assert out["failure_overhead/gate"] == "SKIP"
