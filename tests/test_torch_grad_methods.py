"""ACA, adjoint, naive and mali gradients of the port:
``tests/test_odeint_grad.py`` for the four methods, on the plain path and
the fused kernel path (their plain versions on the CPU). Mali's cases
run the ALF pair integrator (no tableau, no fixed grid) with the
reference test's step budgets; the tests parametrized over the RK
methods keep ``RK_METHODS`` and mali has its own.

Toy problem dz/dt = k·z, L = z(T)²: dL/dz0 = 2 z0 e^{2kT} (paper Eq.
27-29). Tolerances are the reference test's where it has one: analytic
gradient rel 1e-4, fixed grids 0.2 (Euler) / 5e-3, ACA against naive on
one fixed grid rtol=2e-4 atol=2e-6, pytree ACA against naive 1e-3 and
against the adjoint 2e-2, several eval times 1e-3, fused against plain
rtol=1e-5 atol=1e-7 (forward bitwise). Port against ``jax.grad`` of the
reference: max |difference| / max |gradient| <= 1e-5, the ACA parity
test's bound (``tests/test_torch_aca_grad.py``), with equal accepted
steps.

The naive method's trial loop stops at the last eval time where the
reference scans its whole trial budget with the finished trials masked
(ROADMAP queue 3): ``n_steps`` equals the reference's, ``n_trials`` stays
within the budget and equals the port's ACA on the same problem.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import odeint as jodeint
from repro.kernels import ops as jops
from repro_torch.core import GRAD_METHODS, SolveStatus
from repro_torch.core import odeint as todeint
from repro_torch.core import odeint_final as todeint_final
from repro_torch.kernels import ops as tops

K, T = 2.0, 1.0
PARITY = 1e-5
# the ACA cases of tests that test_torch_aca_grad.py holds already
BASELINES = ("adjoint", "naive")
RK_METHODS = ("aca", "adjoint", "naive")


@pytest.fixture(autouse=True)
def _interpret_kernels():
    jops.set_interpret(True)
    yield
    jops.set_interpret(None)


def _rel(port, ref) -> float:
    port, ref = np.asarray(port), np.asarray(ref)
    return float(np.abs(port - ref).max() / np.abs(ref).max())


def test_grad_methods_are_the_references_but_mali():
    """The port's methods are the reference's four, mali included."""
    from repro.core import GRAD_METHODS as REF
    assert GRAD_METHODS == REF
    assert GRAD_METHODS == RK_METHODS + ("mali",)


def _toy_grad(method, solver="dopri5", use_pallas=False, **kw):
    z0 = torch.tensor(1.5, requires_grad=True)
    ys, st = todeint(lambda t, z, k: k * z, z0, [0.0, T], (torch.tensor(K),),
                     solver=solver, grad_method=method,
                     use_pallas=use_pallas, **kw)
    (ys[-1] ** 2).sum().backward()
    return float(z0.grad), 2 * 1.5 * np.exp(2 * K * T)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("method", BASELINES)
def test_toy_gradient_matches_analytic(method, use_pallas):
    g, analytic = _toy_grad(method, use_pallas=use_pallas, rtol=1e-6,
                            atol=1e-6)
    assert abs(g - analytic) / analytic < 1e-4, (method, g, analytic)


@pytest.mark.parametrize("method", RK_METHODS)
@pytest.mark.parametrize("solver", ["euler", "rk2", "rk4"])
def test_fixed_grid_gradient(method, solver):
    g, analytic = _toy_grad(method, solver=solver, steps_per_interval=64)
    tol = 0.2 if solver == "euler" else 5e-3
    assert abs(g - analytic) / analytic < tol, (method, solver, g)


def _tanh_field(t, z, w):
    return torch.tanh(w @ z)


def _tanh_field_j(t, z, w):
    return jnp.tanh(w @ z)


def test_aca_equals_naive_discretize_then_optimize():
    """On one fixed grid ACA and naive differentiate the same discrete
    solution; both match the reference's fixed-grid gradients."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((6, 6)) * 0.4).astype(np.float32)
    z0 = rng.standard_normal(6).astype(np.float32)
    grads = {}
    for m in ("aca", "naive"):
        wt = torch.tensor(w, requires_grad=True)
        ys, _ = todeint(_tanh_field, torch.tensor(z0), [0.0, 1.0], (wt,),
                        solver="rk4", grad_method=m, steps_per_interval=16)
        torch.sum(ys[-1] ** 2).backward()
        grads[m] = wt.grad.numpy()
    np.testing.assert_allclose(grads["aca"], grads["naive"], rtol=2e-4,
                               atol=2e-6)
    g_ref = jax.grad(lambda w: jnp.sum(jodeint(
        _tanh_field_j, jnp.asarray(z0), jnp.array([0.0, 1.0]), (w,),
        solver="rk4", grad_method="naive",
        steps_per_interval=16)[0][-1] ** 2))(jnp.asarray(w))
    for m in ("aca", "naive"):
        assert _rel(grads[m], g_ref) <= PARITY, m


def test_adjoint_reverse_error_vs_aca_stiff():
    """Paper Sec 3.2 (van der Pol): the adjoint's reverse-time
    re-integration drifts on stiff dynamics; ACA at a 10^4x tighter
    tolerance is the ground truth, and at the loose tolerance ACA beats
    the adjoint."""
    mu = torch.tensor(4.0)

    def vdp(t, z, mu):
        return torch.stack([z[1], mu * (1 - z[0] ** 2) * z[1] - z[0]])

    def grad(method, tol):
        z0 = torch.tensor([2.0, 0.0], requires_grad=True)
        ys, _ = todeint(vdp, z0, [0.0, 3.0], (mu,), solver="dopri5",
                        grad_method=method, rtol=tol, atol=tol,
                        max_steps=4096, max_trials=20)
        torch.sum(ys[-1] ** 2).backward()
        return z0.grad

    g_ref = grad("aca", 1e-8)
    err_aca = float((grad("aca", 1e-4) - g_ref).abs().max())
    err_adj = float((grad("adjoint", 1e-4) - g_ref).abs().max())
    assert err_aca < err_adj, (err_aca, err_adj)


def _pair_field(t, z, w):
    return {"a": torch.tanh(w @ z["b"]), "b": torch.tanh(w @ z["a"])}


def _pair_field_j(t, z, w):
    return {"a": jnp.tanh(w @ z["b"]), "b": jnp.tanh(w @ z["a"])}


W44 = (np.random.default_rng(5).standard_normal((4, 4)) * 0.3).astype(
    np.float32)


def _pytree_case(method, use_pallas):
    wt = torch.tensor(W44, requires_grad=True)
    z0 = {"a": torch.ones(4), "b": torch.zeros(4)}
    ys, st = todeint(_pair_field, z0, [0.0, 1.0], (wt,), solver="heun_euler",
                     grad_method=method, rtol=1e-5, atol=1e-5,
                     use_pallas=use_pallas)
    sum(torch.sum(v[-1] ** 2) for v in ys.values()).backward()
    return {k: v.detach() for k, v in ys.items()}, wt.grad.numpy(), st


@functools.lru_cache(maxsize=None)
def _pytree_ref(method):
    z0 = {"a": jnp.ones((4,)), "b": jnp.zeros((4,))}

    def loss(w):
        ys, st = jodeint(_pair_field_j, z0, jnp.array([0.0, 1.0]), (w,),
                         solver="heun_euler", grad_method=method, rtol=1e-5,
                         atol=1e-5)
        return sum(jnp.sum(v[-1] ** 2) for v in ys.values()), (ys, st)

    (_, (ys, st)), g = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(W44))
    return ({k: np.asarray(v) for k, v in ys.items()}, np.asarray(g),
            int(st.n_steps))


def test_pytree_state_and_param_grads():
    """A dict state on the plain path, raveled once per solve: the methods
    agree with each other at the reference test's tolerances and each
    with its reference counterpart."""
    grads = {}
    for m in RK_METHODS:
        ys, g, st = _pytree_case(m, False)
        assert set(ys) == {"a", "b"} and ys["a"].shape == (2, 4)
        ys_r, g_r, n_r = _pytree_ref(m)
        assert int(st.n_steps) == n_r, m
        for k in ys:
            np.testing.assert_allclose(ys[k].numpy(), ys_r[k], rtol=1e-5,
                                       atol=1e-6)
        assert _rel(g, g_r) <= PARITY, m
        grads[m] = g
    np.testing.assert_allclose(grads["aca"], grads["naive"], rtol=1e-3,
                               atol=1e-5)
    np.testing.assert_allclose(grads["aca"], grads["adjoint"], rtol=2e-2,
                               atol=1e-3)


@pytest.mark.parametrize("method", RK_METHODS)
def test_pallas_parity_pytree_state(method):
    """Multi-leaf states ravel once per solve on both paths: the fused
    path's forward is the plain path's bit for bit."""
    ys0, g0, _ = _pytree_case(method, False)
    ys1, g1, _ = _pytree_case(method, True)
    for k in ys0:
        assert torch.equal(ys0[k], ys1[k])
    np.testing.assert_allclose(g1, g0, rtol=1e-5, atol=1e-7)


def test_pytree_structures_round_trip():
    """Tuples, lists and NamedTuples come back as they went in."""
    import collections
    Pair = collections.namedtuple("Pair", "x y")
    for z0 in ((torch.ones(2), torch.zeros(3)),
               [torch.ones(2), (torch.zeros(3),)],
               Pair(torch.ones(2), torch.ones(2, 2))):
        ys, _ = todeint(lambda t, z: torch.utils._pytree.tree_map(
            torch.neg, z), z0, [0.0, 1.0], solver="bosh3", rtol=1e-6,
            atol=1e-6)
        assert type(ys) is type(z0)
        flat_in = torch.utils._pytree.tree_leaves(z0)
        flat_out = torch.utils._pytree.tree_leaves(ys)
        for a, b in zip(flat_in, flat_out):
            assert b.shape == (2,) + a.shape
            np.testing.assert_allclose(b[-1].numpy(), a.numpy() * np.exp(-1),
                                       rtol=1e-4)


def test_mixed_dtype_pytree_raises_named_error():
    """A pytree mixing floating dtypes is a state (its dtype groups keep
    each leaf's dtype); one with a non-floating leaf raises, naming it."""
    with pytest.raises(ValueError, match="floating"):
        todeint(lambda t, z: z, {"a": torch.ones(2),
                                 "b": torch.ones(2, dtype=torch.int64)},
                [0.0, 1.0])
    ys, _ = todeint(lambda t, z: z, {"a": torch.ones(2),
                                     "b": torch.ones(2, dtype=torch.float64)},
                    [0.0, 1.0])
    assert (ys["a"].dtype, ys["b"].dtype) == (torch.float32, torch.float64)


@pytest.mark.parametrize("method", BASELINES)
def test_multi_time_outputs_latent_ode_style(method):
    """Cotangents injected at every eval time."""
    ts = [0.0, 0.3, 0.7, 1.0]
    z0 = torch.tensor(0.7, requires_grad=True)
    ys, _ = todeint(lambda t, z, k: k * z, z0, ts, (torch.tensor(1.0),),
                    solver="dopri5", grad_method=method, rtol=1e-7,
                    atol=1e-7)
    torch.sum(ys ** 2).backward()
    analytic = 2 * 0.7 * float(np.sum(np.exp(2 * np.asarray(ts))))
    assert abs(float(z0.grad) - analytic) / analytic < 1e-3


@pytest.mark.parametrize("method", RK_METHODS)
def test_grad_methods_through_a_stack_of_blocks(method):
    """NODE blocks in a loop over layers (the reference runs them inside
    lax.scan): adaptive and fixed regimes give finite gradients."""
    rng = np.random.default_rng(0)
    P = torch.tensor((rng.standard_normal((3, 4, 4)) * 0.1).astype(
        np.float32), requires_grad=True)
    z = torch.tensor(rng.standard_normal(4).astype(np.float32))
    for solver, kw in (("rk2", dict(steps_per_interval=2)),
                       ("heun_euler", dict(rtol=1e-3, atol=1e-3,
                                           max_steps=32))):
        P.grad = None
        zz = z
        for p in P.unbind(0):
            zz, _ = todeint_final(lambda t, x, p: torch.tanh(x @ p), zz, 0.0,
                                  1.0, (p,), solver=solver,
                                  grad_method=method, **kw)
        (zz ** 2).sum().backward()
        assert torch.isfinite(P.grad).all() and P.grad.abs().sum() > 0


def _parity_case(method, solver, use_pallas, **kw):
    rng = np.random.default_rng(0)
    w = torch.tensor((rng.standard_normal((8, 8)) * 0.4).astype(np.float32),
                     requires_grad=True)
    z0 = torch.tensor(rng.standard_normal(8).astype(np.float32),
                      requires_grad=True)
    ys, st = todeint(_tanh_field, z0, [0.0, 0.5, 1.0], (w,), solver=solver,
                     grad_method=method, use_pallas=use_pallas, **kw)
    torch.sum(ys[-1] ** 2).backward()
    return ys.detach(), w.grad, z0.grad, st


@pytest.mark.parametrize("method", BASELINES)
@pytest.mark.parametrize("solver", ["heun_euler", "bosh3", "dopri5"])
def test_pallas_parity_adaptive(method, solver):
    """The fused flat path reproduces the plain path bit for bit on the
    forward trajectory and matches its gradients."""
    kw = dict(rtol=1e-5, atol=1e-5, max_steps=64)
    ys0, gw0, gz0, st0 = _parity_case(method, solver, False, **kw)
    ys1, gw1, gz1, st1 = _parity_case(method, solver, True, **kw)
    assert torch.equal(ys0, ys1)
    assert int(st0.n_trials) == int(st1.n_trials)
    np.testing.assert_allclose(gw1.numpy(), gw0.numpy(), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(gz1.numpy(), gz0.numpy(), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("method", RK_METHODS)
@pytest.mark.parametrize("solver", ["rk4", "rk2"])
def test_pallas_parity_fixed_grid(method, solver):
    ys0, gw0, gz0, _ = _parity_case(method, solver, False,
                                    steps_per_interval=8)
    ys1, gw1, gz1, _ = _parity_case(method, solver, True,
                                    steps_per_interval=8)
    assert torch.equal(ys0, ys1)
    np.testing.assert_allclose(gw1.numpy(), gw0.numpy(), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(gz1.numpy(), gz0.numpy(), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("method", RK_METHODS)
def test_pallas_path_dispatches(monkeypatch, method):
    """use_pallas=True goes through the kernel wrappers, forward and (for
    the adjoint) in the reverse solve: count the dispatch-layer calls."""
    from repro_torch.core import stepper
    calls = {"combine_err": 0, "increment": 0}
    orig_ce, orig_inc = tops.rk_stage_combine_err, tops.rk_stage_increment

    def ce(*a, **k):
        calls["combine_err"] += 1
        return orig_ce(*a, **k)

    def inc(*a, **k):
        calls["increment"] += 1
        return orig_inc(*a, **k)

    monkeypatch.setattr(stepper.ops, "rk_stage_combine_err", ce)
    monkeypatch.setattr(stepper.ops, "rk_stage_increment", inc)
    z0 = torch.ones(4, requires_grad=True)
    ys, st = todeint(lambda t, z: -z, z0, [0.0, 1.0], solver="dopri5",
                     grad_method=method, rtol=1e-6, atol=1e-6,
                     use_pallas=True)
    forward = dict(calls)
    assert forward["combine_err"] == int(st.n_trials)
    ys[-1].sum().backward()
    assert forward["increment"] > 0
    if method == "naive":
        # the tape's backward runs the kernels' plain versions
        assert calls == forward
    else:
        # ACA replays the steps, the adjoint solves in reverse
        assert calls["increment"] > forward["increment"]
    if method == "adjoint":
        assert calls["combine_err"] > forward["combine_err"]
    assert torch.isfinite(z0.grad).all()


REF_FIELD_CASES = [("heun_euler", 1e-3), ("bosh3", 1e-3), ("dopri5", 1e-4)]


@functools.lru_cache(maxsize=None)
def _ref_time_dependent(method, solver, tol, use_pallas):
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((6, 6)) * 0.5).astype(np.float32)
    z0 = rng.standard_normal(6).astype(np.float32)
    ts = np.asarray([0.0, 0.4, 1.0], np.float32)

    def loss(z0, w):
        ys, st = jodeint(lambda t, z, w: jnp.tanh(w @ z) * jnp.cos(t), z0,
                         jnp.asarray(ts), (w,), grad_method=method,
                         solver=solver, rtol=tol, atol=tol, max_steps=64,
                         use_pallas=use_pallas)
        return jnp.sum(ys ** 2), (ys, st)

    (_, (ys, st)), (gz, gw) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jnp.asarray(z0), jnp.asarray(w))
    return (z0, w, ts, np.asarray(ys), int(st.n_steps), int(st.n_trials),
            np.asarray(gz), np.asarray(gw))


@pytest.mark.parametrize("solver,tol", REF_FIELD_CASES)
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("method", BASELINES)
def test_grads_match_jax_grad_of_reference(method, solver, tol, use_pallas):
    """dL/dz0 and dL/dargs against jax.grad of the reference, several eval
    times, time-dependent field; the ACA cases are in
    test_torch_aca_grad.py."""
    z0, w, ts, ys_r, n_r, trials_r, gz_r, gw_r = _ref_time_dependent(
        method, solver, tol, use_pallas)
    zt = torch.tensor(z0, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    ys, st = todeint(lambda t, z, w: torch.tanh(w @ z) * torch.cos(t), zt,
                     torch.tensor(ts), (wt,), grad_method=method,
                     solver=solver, rtol=tol, atol=tol, max_steps=64,
                     use_pallas=use_pallas)
    torch.sum(ys ** 2).backward()
    assert int(st.n_steps) == n_r
    if method == "adjoint":
        assert int(st.n_trials) == trials_r
    else:
        assert int(st.n_trials) <= trials_r == 64 * 12
    np.testing.assert_allclose(ys.detach().numpy(), ys_r, rtol=1e-5,
                               atol=1e-6)
    assert _rel(zt.grad, gz_r) <= PARITY
    assert _rel(wt.grad, gw_r) <= PARITY


@pytest.mark.parametrize("solver,tol", REF_FIELD_CASES)
def test_naive_counts_the_trials_it_takes(solver, tol):
    """The naive method's accepted steps and trials are ACA's on the same
    problem: its loop takes the trials ACA's engine takes (ACA reuses the
    last stage as the next first stage, which gives the bits the naive
    method recomputes), and reports them where the reference reports its
    budget."""
    kw = dict(rtol=tol, atol=tol, max_steps=64)
    _, _, _, st_aca = _parity_case("aca", solver, False, **kw)
    _, _, _, st_nv = _parity_case("naive", solver, False, **kw)
    from repro_torch.core import get_tableau
    tab = get_tableau(solver)
    assert int(st_nv.n_steps) == int(st_aca.n_steps)
    assert int(st_nv.n_trials) == int(st_aca.n_trials)
    assert int(st_nv.nfe) == int(st_nv.n_trials) * tab.stages
    assert int(st_nv.status) == int(st_aca.status) == SolveStatus.OK


def test_naive_trial_budget_runs_out_with_status():
    _, st = todeint(lambda t, z: -z, torch.ones(3), [0.0, 1.0],
                    solver="dopri5", grad_method="naive", rtol=1e-8,
                    atol=1e-8, trial_budget=3)
    assert int(st.n_trials) == 3 and bool(st.overflow)
    assert int(st.status) == SolveStatus.TRIAL_BUDGET_EXHAUSTED


@pytest.mark.parametrize("method", BASELINES)
def test_frozen_solve_status_and_cotangents(method):
    """A solve that runs into a NaN wall freezes with NONFINITE_STATE: the
    adjoint zeroes the cotangents (exact-zero gradients), the naive
    method keeps the failing trial on its tape, as the reference's."""
    z0 = torch.ones(3, requires_grad=True)
    ys, st = todeint(
        lambda t, z: torch.where(t > 0.5, torch.full_like(z, float("nan")),
                                 -z),
        z0, [0.0, 1.0], solver="dopri5", grad_method=method, rtol=1e-6,
        atol=1e-6)
    assert int(st.status) == SolveStatus.NONFINITE_STATE
    assert torch.isfinite(ys).all()
    if method == "adjoint":
        ys[-1].sum().backward()
        assert torch.equal(z0.grad, torch.zeros(3))


@pytest.mark.parametrize("method", RK_METHODS)
@pytest.mark.parametrize("use_pallas", [False, True])
def test_fixed_grid_matches_reference(method, use_pallas):
    """Fixed grids against the reference: outputs and gradients of every
    method (the adjoint's reverse solve on the same grid)."""
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((5, 5)) * 0.5).astype(np.float32)
    z0 = rng.standard_normal(5).astype(np.float32)
    ts = [0.0, 0.5, 1.0]
    wt = torch.tensor(w, requires_grad=True)
    ys, st = todeint(_tanh_field, torch.tensor(z0), ts, (wt,), solver="rk4",
                     grad_method=method, steps_per_interval=4,
                     use_pallas=use_pallas)
    torch.sum(ys ** 2).backward()
    assert (int(st.n_steps), int(st.nfe)) == (8, 32)

    def loss(w):
        ys, _ = jodeint(_tanh_field_j, jnp.asarray(z0), jnp.asarray(ts), (w,),
                        solver="rk4", grad_method=method,
                        steps_per_interval=4, use_pallas=use_pallas)
        return jnp.sum(ys ** 2), ys

    (_, ys_r), g_r = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(w))
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(ys_r),
                               rtol=1e-6, atol=1e-7)
    assert _rel(wt.grad, g_r) <= PARITY


@pytest.mark.parametrize("kw,match", [
    (dict(solver="rk4", h0=0.1), "h0 overrides"),
    (dict(grad_method="adjoint", checkpoint_segments=4),
     "checkpoint_segments requires grad_method='aca'"),
    (dict(solver="rk2", checkpoint_segments="auto"),
     "checkpoint_segments requires grad_method='aca'"),
    (dict(solver="euler", interpolate_ts=True),
     "interpolate_ts requires an adaptive solver"),
])
def test_reference_validation_errors(kw, match):
    with pytest.raises(ValueError, match=match):
        todeint(lambda t, z: -z, torch.ones(3), [0.0, 1.0], **kw)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("field", ["zero", "constant"])
def test_naive_gradient_is_finite_where_the_field_or_error_vanishes(
        field, use_pallas):
    """A field that vanishes at the start (w = 0) or an error estimate that
    is exactly 0 (a constant field) puts sqrt(0) and a division by 0 in an
    unselected branch on the naive tape; the reference's naive gradient is
    NaN there. The port's is ACA's (d sum z(1) / dw = 3 e^0 at w = 0,
    d sum z(1) / dc = 3 for dz/dt = c)."""
    if field == "zero":
        def f(t, z, w):
            return w * z
        p0 = 0.0
    else:
        def f(t, z, w):
            return w * torch.ones_like(z)
        p0 = 0.5
    grads = {}
    for m in ("aca", "naive"):
        p = torch.tensor(p0, requires_grad=True)
        ys, _ = todeint(f, torch.ones(3), [0.0, 1.0], (p,), solver="dopri5",
                        grad_method=m, rtol=1e-5, atol=1e-5, max_steps=16,
                        use_pallas=use_pallas)
        ys[-1].sum().backward()
        grads[m] = float(p.grad)
    assert np.isfinite(grads["naive"])
    assert abs(grads["naive"] - grads["aca"]) <= 1e-6 * abs(grads["aca"])
    assert abs(grads["aca"] - 3.0) <= 1e-6


def test_sqrt0_is_sqrt_with_a_zero_slope_at_zero():
    from repro_torch.core.controller import sqrt0
    x = torch.tensor([0.0, 1e-30, 2.0, float("inf"), float("nan")],
                     requires_grad=True)
    y = sqrt0(x)
    ref = torch.sqrt(x.detach())
    assert torch.equal(y.detach()[:4], ref[:4]) and torch.isnan(y[4])
    y[:3].sum().backward()
    assert x.grad[0] == 0.0 and torch.isfinite(x.grad[:3]).all()
    assert x.grad[2] == 0.5 / ref[2]


@pytest.mark.parametrize("batched", [False, True])
def test_adjoint_forward_keeps_no_checkpoint_buffer(batched):
    """``checkpoint=False`` (the adjoint's forward) allocates no per-step
    buffer and solves bit for bit as the checkpointed ACA forward."""
    from repro_torch.core.controller import ControllerConfig
    from repro_torch.core.integrate import (adaptive_while_solve,
                                            batched_adaptive_while_solve)
    from repro_torch.core.tableaus import get_tableau
    engine = batched_adaptive_while_solve if batched else \
        adaptive_while_solve
    z0 = torch.tensor(np.random.default_rng(4).standard_normal(
        (3, 5) if batched else 5).astype(np.float32))
    ts = torch.tensor([0.0, 0.5, 1.0])
    out = [engine(get_tableau("bosh3"), lambda t, z: -z * torch.cos(t), z0,
                  ts, (), 1e-5, 1e-5, ControllerConfig(), checkpoint=c)
           for c in (True, False)]
    assert out[0][1] is not None and out[1][1] is None
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][2], out[1][2]):
        assert torch.equal(a, b)


# --------------------------------------------------------------- mali
# ``tests/test_odeint_grad.py``'s mali cases: the ALF pair integrator
# (solver None), 2nd order with a 1st-order embedded estimate, so the
# reference's larger step budgets

@pytest.mark.parametrize("use_pallas", [False, True])
def test_mali_toy_gradient_matches_analytic(use_pallas):
    g, analytic = _toy_grad("mali", solver=None, use_pallas=use_pallas,
                            rtol=1e-6, atol=1e-6, max_steps=8192)
    assert abs(g - analytic) / analytic < 1e-4, (g, analytic)


def test_mali_pytree_state_and_param_grads():
    """A dict state under mali: its gradient differentiates the ALF
    discretization, so it meets ACA's at the solve-tolerance scale (the
    reference's rtol=2e-2, atol=1e-3), and the fused path's forward is the
    plain one's bit for bit."""
    grads, ys_by = {}, {}
    for up in (False, True):
        wt = torch.tensor(W44, requires_grad=True)
        z0 = {"a": torch.ones(4), "b": torch.zeros(4)}
        ys, _ = todeint(_pair_field, z0, [0.0, 1.0], (wt,),
                        grad_method="mali", rtol=1e-5, atol=1e-5,
                        max_steps=2048, use_pallas=up)
        sum(torch.sum(v[-1] ** 2) for v in ys.values()).backward()
        grads[up], ys_by[up] = wt.grad.numpy(), ys
    for k in ys_by[False]:
        assert torch.equal(ys_by[False][k], ys_by[True][k])
    np.testing.assert_allclose(grads[True], grads[False], rtol=1e-5,
                               atol=1e-7)
    _, g_aca, _ = _pytree_case("aca", False)
    np.testing.assert_allclose(g_aca, grads[False], rtol=2e-2, atol=1e-3)


def test_mali_multi_time_outputs_latent_ode_style():
    ts = [0.0, 0.3, 0.7, 1.0]
    z0 = torch.tensor(0.7, requires_grad=True)
    ys, _ = todeint(lambda t, z, k: k * z, z0, ts, (torch.tensor(1.0),),
                    grad_method="mali", rtol=1e-6, atol=1e-6,
                    max_steps=8192)
    torch.sum(ys ** 2).backward()
    analytic = 2 * 0.7 * float(np.sum(np.exp(2 * np.asarray(ts))))
    assert abs(float(z0.grad) - analytic) / analytic < 1e-3


def test_mali_through_a_stack_of_blocks():
    """MALI blocks in a loop over layers give finite, nonzero
    gradients."""
    rng = np.random.default_rng(0)
    P = torch.tensor((rng.standard_normal((3, 4, 4)) * 0.1).astype(
        np.float32), requires_grad=True)
    zz = torch.tensor(rng.standard_normal(4).astype(np.float32))
    for p in P.unbind(0):
        zz, _ = todeint_final(lambda t, x, p: torch.tanh(x @ p), zz, 0.0,
                              1.0, (p,), grad_method="mali", rtol=1e-3,
                              atol=1e-3, max_steps=64)
    (zz ** 2).sum().backward()
    assert torch.isfinite(P.grad).all() and P.grad.abs().sum() > 0


def test_mali_pallas_parity_adaptive():
    """The fused path (K1 half-drifts in the backward) against the plain
    path: the forward bit for bit (the same lattice arithmetic), the
    gradients within rtol=1e-5, atol=1e-7 (the reference test's)."""
    kw = dict(rtol=1e-5, atol=1e-5, max_steps=2048)
    ys0, gw0, gz0, st0 = _parity_case("mali", None, False, **kw)
    ys1, gw1, gz1, st1 = _parity_case("mali", None, True, **kw)
    assert torch.equal(ys0, ys1)
    assert int(st0.n_trials) == int(st1.n_trials)
    np.testing.assert_allclose(gw1.numpy(), gw0.numpy(), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(gz1.numpy(), gz0.numpy(), rtol=1e-5,
                               atol=1e-7)
