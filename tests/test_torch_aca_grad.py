"""ACA gradients of the port: the aca cases of ``tests/test_odeint_grad.py``.

Toy problem dz/dt = k·z, L = z(T)²: dL/dz0 = 2 z0 e^{2kT} (paper Eq.
27-29). Tolerances: analytic gradient rel 1e-4 as in the reference test;
fused vs plain-tensor gradients rtol=1e-5, atol=1e-7 as in the
reference's own parity test (forward bitwise); port vs ``jax.grad`` of
the reference: max |difference| / max |gradient| <= 1e-5, on problems
whose error estimates sit well above f32 rounding — equal accepted steps,
grids apart by ulps of matmul summation and of XLA's fused stage sums
(see test_torch_solve.py), which a small gradient entry feels relative
to itself but not to the gradient's scale (``tests/
torch_parity_report.py`` measures <= 2.8e-7 against the scale and up to
8.2e-5 per element).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import odeint as jodeint
from repro.kernels import ops as jops
from repro_torch.core import odeint as todeint
from repro_torch.core import odeint_final as todeint_final

K, T = 2.0, 1.0


@pytest.fixture(autouse=True)
def _interpret_kernels():
    jops.set_interpret(True)
    yield
    jops.set_interpret(None)


def _toy_grad(use_pallas, **kw):
    z0 = torch.tensor(1.5, requires_grad=True)
    ys, _ = todeint(lambda t, z, k: k * z, z0, [0.0, T], (torch.tensor(K),),
                    solver="dopri5", use_pallas=use_pallas, **kw)
    (ys[-1] ** 2).sum().backward()
    return float(z0.grad), 2 * 1.5 * np.exp(2 * K * T)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_toy_gradient_matches_analytic(use_pallas):
    g, analytic = _toy_grad(use_pallas, rtol=1e-6, atol=1e-6)
    assert abs(g - analytic) / analytic < 1e-4, (g, analytic)


def _f(t, z, w):
    return torch.tanh(w @ z)


def _parity_case(solver, use_pallas, **kw):
    rng = np.random.default_rng(0)
    w = torch.tensor((rng.standard_normal((8, 8)) * 0.4).astype(np.float32),
                     requires_grad=True)
    z0 = torch.tensor(rng.standard_normal(8).astype(np.float32),
                      requires_grad=True)
    ys, st = todeint(_f, z0, [0.0, 0.5, 1.0], (w,), solver=solver,
                     use_pallas=use_pallas, **kw)
    torch.sum(ys[-1] ** 2).backward()
    return ys.detach(), w.grad, z0.grad, st


@pytest.mark.parametrize("solver", ["heun_euler", "bosh3", "dopri5"])
def test_pallas_parity_adaptive(solver):
    """The fused flat path reproduces the plain-tensor path bit for bit
    on the forward trajectory and matches its gradients."""
    kw = dict(rtol=1e-5, atol=1e-5, max_steps=64)
    ys0, gw0, gz0, _ = _parity_case(solver, False, **kw)
    ys1, gw1, gz1, _ = _parity_case(solver, True, **kw)
    assert torch.equal(ys0, ys1)
    np.testing.assert_allclose(gw1.numpy(), gw0.numpy(), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(gz1.numpy(), gz0.numpy(), rtol=1e-5,
                               atol=1e-7)


def test_solver_stats():
    ys, stats = todeint(lambda t, z: -z, torch.tensor(1.0), [0.0, 1.0],
                        solver="dopri5", rtol=1e-6, atol=1e-6)
    assert int(stats.n_steps) > 0
    assert int(stats.nfe) >= int(stats.n_steps) * 6
    assert not bool(stats.overflow)


def test_overflow_flag():
    _, stats = todeint(lambda t, z: 50 * torch.cos(50 * t) * z,
                       torch.tensor(1.0), [0.0, 10.0], solver="dopri5",
                       rtol=1e-9, atol=1e-9, max_steps=4)
    assert bool(stats.overflow)


def test_multi_time_outputs_latent_ode_style():
    """Cotangents injected at every eval time."""
    ts = [0.0, 0.3, 0.7, 1.0]
    z0 = torch.tensor(0.7, requires_grad=True)
    ys, _ = todeint(lambda t, z, k: k * z, z0, ts, (torch.tensor(1.0),),
                    solver="dopri5", rtol=1e-7, atol=1e-7)
    torch.sum(ys ** 2).backward()
    analytic = 2 * 0.7 * float(np.sum(np.exp(2 * np.asarray(ts))))
    assert abs(float(z0.grad) - analytic) / analytic < 1e-3


@pytest.mark.parametrize("solver,tol", [("heun_euler", 1e-3),
                                        ("bosh3", 1e-3), ("dopri5", 1e-4)])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_grads_match_jax_grad_of_reference(solver, tol, use_pallas):
    """dL/dz0 and dL/dargs against jax.grad of the reference, several
    eval times, time-dependent field."""
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((6, 6)) * 0.5).astype(np.float32)
    z0 = rng.standard_normal(6).astype(np.float32)
    ts = np.asarray([0.0, 0.4, 1.0], np.float32)
    kw = dict(solver=solver, rtol=tol, atol=tol, max_steps=64,
              use_pallas=use_pallas)

    def loss_j(z0, w):
        ys, st = jodeint(lambda t, z, w: jnp.tanh(w @ z) * jnp.cos(t), z0,
                         jnp.asarray(ts), (w,), grad_method="aca", **kw)
        return jnp.sum(ys ** 2), st

    (l_j, st_j), (gz_j, gw_j) = jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True)(jnp.asarray(z0),
                                              jnp.asarray(w))
    zt = torch.tensor(z0, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    ys, st_t = todeint(lambda t, z, w: torch.tanh(w @ z) * torch.cos(t), zt,
                       torch.tensor(ts), (wt,), **kw)
    torch.sum(ys ** 2).backward()
    assert int(st_t.n_steps) == int(st_j.n_steps)
    assert int(st_t.nfe) == int(st_j.nfe)
    for gp, gr in ((zt.grad.numpy(), np.asarray(gz_j)),
                   (wt.grad.numpy(), np.asarray(gw_j))):
        err = np.abs(gp - gr).max() / np.abs(gr).max()
        assert err <= 1e-5, err


def test_args_in_a_dict_and_non_differentiable_leaves():
    """``args`` may nest tensors in a dict (the NODE block's parameters);
    leaves without requires_grad get no gradient, others do."""
    w = torch.tensor([[0.3, -0.2], [0.1, 0.4]], requires_grad=True)
    c = torch.tensor(0.5)
    z0 = torch.tensor([1.0, -1.0], requires_grad=True)
    zT, _ = todeint_final(lambda t, z, p: torch.tanh(p["w"] @ z) * p["c"],
                          z0, 0.0, 1.0, ({"w": w, "c": c},),
                          solver="bosh3", rtol=1e-6, atol=1e-6)
    zT.sum().backward()
    assert w.grad is not None and torch.isfinite(w.grad).all()
    assert c.grad is None
    assert z0.grad is not None and torch.isfinite(z0.grad).all()


def test_frozen_solve_gets_zero_cotangents():
    """A NONFINITE_STATE solve's placeholder outputs carry no gradient."""
    z0 = torch.ones(3, requires_grad=True)
    ys, st = todeint(
        lambda t, z: torch.where(t > 0.5, torch.full_like(z, float("nan")),
                                 -z),
        z0, [0.0, 1.0], solver="dopri5", rtol=1e-6, atol=1e-6)
    assert int(st.status) == 1
    ys[-1].sum().backward()
    assert torch.equal(z0.grad, torch.zeros(3))
