"""Per-row eval times in the port's batched engine: ``odeint(...,
batch_axis=0)`` with ``ts`` of shape (B, T), the counterpart of
``jax.vmap`` of the reference's solo ``odeint`` over per-sample times
(``benchmarks/bench_timeseries.py``'s decoder).

The reference test's heterogeneous batch (per-row stiffness exp(logk)
inside the state, one shared ``w``) with every row on its own eval times,
the start times differing too; Dopri5 at rtol=atol=1e-5 (the error
estimate two orders above f32 rounding), for aca, adjoint and naive, on
the plain path and the kernels' plain versions (``use_pallas``):

* against ``jax.vmap`` of the reference's solo solve: per-row accepted
  steps equal (and trials and evaluations, except the naive method's,
  which counts the trials it takes: ROADMAP queue 3), ``ys`` and the
  gradients of z0 and w within 1e-5 of their max |value|;
* inside the port, bitwise on the CPU: row b of the per-row solve equals
  row b of the batch solved with ``ts[b]`` for every row (outputs, the
  row's z0 gradient and its counters);
* descending per-row times: the hand-negated ascending problem, bitwise;
* the named errors: 2-D ``ts`` without ``batch_axis``, a row count that
  is not B, rows in different directions, a fixed-step solver.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import odeint as jodeint
from repro_torch.core import odeint as todeint

KW = dict(solver="dopri5", rtol=1e-5, atol=1e-5, max_steps=64)
W = np.float32(0.7)
B, T = 4, 4
MAX_REL = 1e-5


def _f_j(t, z, w):
    x, logk = z[:-1], z[-1]
    dx = -jnp.exp(logk) * x + 0.1 * jnp.tanh(w * x)
    return jnp.concatenate([dx, jnp.zeros((1,), z.dtype)])


def _f_t(t, z, w):
    x, logk = z[:-1], z[-1]
    dx = -torch.exp(logk) * x + 0.1 * torch.tanh(w * x)
    return torch.cat([dx, torch.zeros(1, dtype=z.dtype, device=z.device)])


def _inputs():
    x0 = np.random.default_rng(1).standard_normal((B, 3))
    logk = np.linspace(0.0, 3.5, B)
    z0 = np.concatenate([x0, logk[:, None]], axis=1).astype(np.float32)
    rng = np.random.default_rng(2)
    ts = np.sort(rng.uniform(0.0, 1.5, (B, T)), axis=1)
    ts[:, 0] = rng.uniform(0.0, 0.3, B)
    return z0, ts.astype(np.float32)


def _port(method, use_pallas, ts, row=None):
    z0, _ = _inputs()
    zz = torch.tensor(z0, requires_grad=True)
    ww = torch.tensor(W, requires_grad=True)
    ys, st = todeint(_f_t, zz, torch.tensor(ts), (ww,), grad_method=method,
                     batch_axis=0, use_pallas=use_pallas, **KW)
    out = ys if row is None else ys[:, row]
    torch.sum(out ** 2).backward()
    return ys.detach(), st, zz.grad, ww.grad


@functools.lru_cache(maxsize=None)
def _vmap_of_solo(method):
    z0, ts = _inputs()

    def loss(z0, w):
        ys, st = jax.vmap(lambda z, t: jodeint(
            _f_j, z, t, (w,), grad_method=method, **KW))(z0, jnp.asarray(ts))
        return jnp.sum(ys ** 2), (ys, st)

    (_, (ys, st)), (gz, gw) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jnp.asarray(z0), jnp.float32(W))
    stats = {k: np.asarray(v) for k, v in st._asdict().items()}
    return np.asarray(ys), stats, np.asarray(gz), np.asarray(gw)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("method", ["aca", "adjoint", "naive"])
def test_matches_vmap_of_reference_solo(method, use_pallas):
    _, ts = _inputs()
    ys_t, st_t, gz_t, gw_t = _port(method, use_pallas, ts)
    ys_j, st_j, gz_j, gw_j = _vmap_of_solo(method)
    steps = st_t.n_steps.numpy()
    np.testing.assert_array_equal(steps, st_j["n_steps"])
    assert len(np.unique(steps)) > 1
    if method == "naive":
        assert (st_t.n_trials.numpy() <= st_j["n_trials"]).all()
    else:
        np.testing.assert_array_equal(st_t.n_trials.numpy(),
                                      st_j["n_trials"])
        np.testing.assert_array_equal(st_t.nfe.numpy(), st_j["nfe"])
    np.testing.assert_array_equal(st_t.status.numpy(), st_j["status"])
    # the reference's vmap stacks samples first: (B, T, d)
    assert _rel(ys_t.numpy().transpose(1, 0, 2), ys_j) <= MAX_REL
    assert _rel(gz_t.numpy(), gz_j) <= MAX_REL
    assert _rel(gw_t.numpy(), gw_j) <= MAX_REL


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("method", ["aca", "adjoint", "naive"])
def test_row_equals_broadcast_row(method, use_pallas):
    _, ts = _inputs()
    for b in range(B):
        ys, st, gz, _ = _port(method, use_pallas, ts, row=b)
        ys_b, st_b, gz_b, _ = _port(
            method, use_pallas, np.broadcast_to(ts[b], (B, T)).copy(), row=b)
        assert torch.equal(ys[:, b], ys_b[:, b])
        assert torch.equal(gz[b], gz_b[b])
        assert int(st.n_steps[b]) == int(st_b.n_steps[b])
        assert int(st.n_trials[b]) == int(st_b.n_trials[b])


@pytest.mark.parametrize("method", ["aca", "adjoint", "naive"])
def test_descending_rows_are_the_negated_problem(method):
    _, ts = _inputs()
    z0, _ = _inputs()
    rev = -ts[:, ::-1].copy() + 2.0        # descending per row

    def run(f, times):
        zz = torch.tensor(z0, requires_grad=True)
        ys, _ = todeint(f, zz, torch.tensor(times), (torch.tensor(W),),
                        grad_method=method, batch_axis=0, **KW)
        torch.sum(ys[-1] ** 2).backward()
        return ys.detach(), zz.grad

    def f_neg(s, z, w):
        return -_f_t(-s, z, w)

    ys_d, g_d = run(_f_t, rev)
    ys_a, g_a = run(f_neg, -rev)
    assert torch.equal(ys_d, ys_a)
    assert _rel(g_d.numpy(), g_a.numpy()) <= 1e-6


def test_per_row_ts_errors():
    z0, ts = _inputs()
    zz, tt = torch.tensor(z0), torch.tensor(ts)
    with pytest.raises(ValueError, match="requires batch_axis"):
        todeint(_f_t, zz[0], tt, (torch.tensor(W),), **KW)
    with pytest.raises(ValueError, match="one row of eval times per batch"):
        todeint(_f_t, zz, tt[:2], (torch.tensor(W),), batch_axis=0, **KW)
    mixed = tt.clone()
    mixed[1] = mixed[1].flip(0)
    with pytest.raises(ValueError, match="one direction"):
        todeint(_f_t, zz, mixed, (torch.tensor(W),), batch_axis=0, **KW)
    with pytest.raises(ValueError, match="adaptive solver"):
        todeint(_f_t, zz, tt, (torch.tensor(W),), batch_axis=0,
                solver="rk4")
