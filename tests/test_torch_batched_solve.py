"""Per-sample batched adaptive solving of the port (``odeint(...,
batch_axis=0)``), mirroring ``tests/test_batched_solve.py``.

The same numpy inputs go through the reference (JAX on the CPU, Pallas in
interpret mode) and the port (CPU, the kernels' plain versions), with the
reference test's field ``_f`` and heterogeneous batch ``_hetero_batch``:
per-row stiffness exp(logk) rides inside the state, so one shared ``w``
still gives every row its own grid.

* Port against reference, both at ``batch_axis=0``: per-row accepted
  steps equal; ``ys`` and the gradients of z0 and w within rtol=1e-5 and
  atol=1e-7 (w: 1e-6), the tolerances of the reference's own
  batched-vs-vmap test. Dopri5 at rtol=atol=1e-5 keeps the error estimate
  two orders above f32 rounding (ROADMAP queue 3 for where it is not).
* Port batched row b against the port's solo solve of row b: counters
  equal and ``ys`` within 1e-6 (the vmapped field and the per-row norm
  reduce in another order than the solo ones).
* Inside the port, bitwise: finished rows freeze, ``batch_axis`` != 0 is
  axis 0 moved, and a NaN row freezes while the others are the batch
  without it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import odeint as jodeint
from repro.kernels import ops as jops
from repro_torch.core import SolveStatus
from repro_torch.core import odeint as todeint

TS = [0.0, 0.5, 1.0]
KW = dict(solver="dopri5", rtol=1e-5, atol=1e-5, max_steps=64)
W = np.float32(0.7)


def _f_j(t, z, w):
    x, logk = z[:-1], z[-1]
    dx = -jnp.exp(logk) * x + 0.1 * jnp.tanh(w * x)
    return jnp.concatenate([dx, jnp.zeros((1,), z.dtype)])


def _f_t(t, z, w):
    x, logk = z[:-1], z[-1]
    dx = -torch.exp(logk) * x + 0.1 * torch.tanh(w * x)
    return torch.cat([dx, torch.zeros(1, dtype=z.dtype, device=z.device)])


def _hetero_batch(B=4, d=4, seed=1):
    x0 = np.random.default_rng(seed).standard_normal((B, d - 1))
    logk = np.linspace(0.0, 3.5, B)
    return np.concatenate([x0, logk[:, None]], axis=1).astype(np.float32)


@pytest.fixture
def _interpret_kernels():
    jops.set_interpret(True)
    yield
    jops.set_interpret(None)


def _port_case(z0, use_pallas, batch_axis=0, f=_f_t, **kw):
    zz = torch.tensor(z0, requires_grad=True)
    ww = torch.tensor(W, requires_grad=True)
    ys, st = todeint(f, zz, TS, (ww,), grad_method="aca",
                     batch_axis=batch_axis, use_pallas=use_pallas,
                     **{**KW, **kw})
    torch.sum(ys[-1] ** 2).backward()
    return ys.detach().numpy(), st, zz.grad.numpy(), ww.grad.numpy()


def _ref_case(z0, use_pallas):
    def loss(w, z0):
        ys, st = jodeint(_f_j, z0, jnp.asarray(TS, jnp.float32), (w,),
                         grad_method="aca", batch_axis=0,
                         use_pallas=use_pallas, **KW)
        return jnp.sum(ys[-1] ** 2), (ys, st)

    (_, (ys, st)), (gw, gz) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jnp.float32(W), jnp.asarray(z0))
    return np.asarray(ys), st, np.asarray(gz), np.asarray(gw)


def test_per_element_grids_not_lockstep():
    """Heterogeneous stiffness: every row records its own grid; the
    lockstep solve (stacked state, one controller) takes one shared grid
    and makes the easy rows overpay."""
    z0 = _hetero_batch()
    _, st, _, _ = _port_case(z0, False)
    n = st.n_steps.numpy()
    assert n.shape == (z0.shape[0],)
    assert len(np.unique(n)) > 1, n

    def fb(t, zb, w):
        return torch.stack([_f_t(t, z, w) for z in zb])

    _, st_lock = todeint(fb, torch.tensor(z0), TS, (torch.tensor(W),),
                         grad_method="aca", **KW)
    assert st_lock.n_steps.shape == ()
    assert int(st_lock.n_steps) > int(n.min())


@pytest.mark.parametrize("use_pallas", [False, True])
def test_matches_reference_batched(use_pallas, _interpret_kernels):
    """Port batch_axis=0 against reference batch_axis=0, ACA: same
    per-row grids, outputs and gradients."""
    z0 = _hetero_batch()
    ys_t, st_t, gz_t, gw_t = _port_case(z0, use_pallas)
    ys_j, st_j, gz_j, gw_j = _ref_case(z0, use_pallas)
    for field in ("n_steps", "n_trials", "nfe", "status", "overflow"):
        np.testing.assert_array_equal(getattr(st_t, field).numpy(),
                                      np.asarray(getattr(st_j, field)),
                                      err_msg=field)
    assert len(np.unique(st_t.n_steps.numpy())) > 1
    np.testing.assert_allclose(ys_t, ys_j, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(gz_t, gz_j, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(gw_t, gw_j, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_batched_rows_match_port_solo(use_pallas):
    """Row b of the batched solve against the port's solo solve of row b:
    the same counters, ``ys`` within 1e-6."""
    z0 = _hetero_batch()
    ys_b, st_b, gz_b, _ = _port_case(z0, use_pallas)
    for b in range(z0.shape[0]):
        ys_s, st_s, gz_s, _ = _port_case(z0[b], use_pallas, batch_axis=None)
        for field in ("n_steps", "n_trials", "nfe", "status"):
            assert int(getattr(st_b, field)[b]) == int(getattr(st_s, field))
        np.testing.assert_allclose(ys_b[:, b], ys_s, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(gz_b[b], gz_s, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_finished_elements_freeze_bit_stable(use_pallas):
    """A stiff straggler keeps the loop alive; the easy rows' outputs, stats
    and gradients stay bit-identical to the batch without it."""
    z_easy = _hetero_batch(B=2)
    stiff = np.concatenate([np.full((1, 3), 0.5), np.full((1, 1), 4.2)],
                           axis=1).astype(np.float32)
    z_more = np.concatenate([z_easy, stiff], axis=0)
    ys2, st2, gz2, _ = _port_case(z_easy, use_pallas)
    ys3, st3, gz3, _ = _port_case(z_more, use_pallas)
    assert int(st3.n_steps[2]) > int(st3.n_steps[:2].max())
    np.testing.assert_array_equal(ys2, ys3[:, :2])
    for a, b in zip(st2, st3):
        np.testing.assert_array_equal(a.numpy(), b.numpy()[:2])
    np.testing.assert_array_equal(gz2, gz3[:2])


def test_batch_axis_nonzero():
    """batch_axis=1 (and -1) is batch_axis=0 on the moved state, moved
    back, bit for bit."""
    z0 = _hetero_batch()
    ys0, st0, _, _ = _port_case(z0, False)
    for ba in (1, -1):
        ys1, st1, gz1, _ = _port_case(np.ascontiguousarray(z0.T), False,
                                      batch_axis=ba)
        np.testing.assert_array_equal(ys0, np.swapaxes(ys1, 1, 2))
        np.testing.assert_array_equal(st0.n_steps.numpy(),
                                      st1.n_steps.numpy())
        assert gz1.shape == z0.T.shape


def test_per_element_overflow():
    """max_steps runs out per row: the stiff row overflows, the easy one
    lands on its eval times."""
    z0 = np.stack([
        np.concatenate([np.full(3, 0.3), [0.0]]),
        np.concatenate([np.full(3, 0.3), [5.5]]),
    ]).astype(np.float32)
    _, st = todeint(_f_t, torch.tensor(z0), TS, (torch.tensor(W),),
                    grad_method="aca", batch_axis=0, solver="dopri5",
                    rtol=1e-7, atol=1e-7, max_steps=12)
    ov = st.overflow.numpy()
    assert not ov[0] and ov[1], ov
    assert st.status.tolist() == [SolveStatus.OK,
                                  SolveStatus.CHECKPOINT_OVERFLOW]


@pytest.mark.parametrize("use_pallas", [False, True])
def test_nonfinite_row_freezes_others_unchanged(use_pallas):
    """A row whose field turns NaN at t >= 0.3 freezes with
    NONFINITE_STATE at its last good state (finite outputs, zero
    gradient); the other rows are bitwise the batch without it."""
    def f_nan(t, z, w):
        out = _f_t(t, z, w)
        poison = (t >= 0.3) & (z[-1] < -5.0)
        return torch.where(poison, torch.full_like(out, float("nan")), out)

    z_ok = _hetero_batch(B=3)
    bad = np.concatenate([np.full((1, 3), 0.2), np.full((1, 1), -6.0)],
                         axis=1).astype(np.float32)
    z_all = np.concatenate([z_ok[:1], bad, z_ok[1:]], axis=0)
    ys_a, st_a, gz_a, _ = _port_case(z_all, use_pallas, f=f_nan,
                                     solver="heun_euler", rtol=1e-3,
                                     atol=1e-3)
    ys_o, st_o, gz_o, _ = _port_case(z_ok, use_pallas, f=f_nan,
                                     solver="heun_euler", rtol=1e-3,
                                     atol=1e-3)
    assert st_a.status.tolist() == [0, SolveStatus.NONFINITE_STATE, 0, 0]
    assert np.isfinite(ys_a).all()
    np.testing.assert_array_equal(gz_a[1], np.zeros(4, np.float32))
    keep = [0, 2, 3]
    np.testing.assert_array_equal(ys_a[:, keep], ys_o)
    np.testing.assert_array_equal(gz_a[keep], gz_o)
    for a, b in zip(st_a, st_o):
        np.testing.assert_array_equal(a.numpy()[keep], b.numpy())


def test_per_row_h0_matches_solo_h0():
    """A (B,) h0 gives each row the solve it gets alone with that h0."""
    z0 = _hetero_batch(B=3)
    h0 = np.asarray([1e-3, 5e-2, 2e-2], np.float32)
    ys_b, st_b = todeint(_f_t, torch.tensor(z0), TS, (torch.tensor(W),),
                         batch_axis=0, h0=torch.tensor(h0), **KW)
    for b in range(3):
        ys_s, st_s = todeint(_f_t, torch.tensor(z0[b]), TS,
                             (torch.tensor(W),), h0=float(h0[b]), **KW)
        assert int(st_b.n_trials[b]) == int(st_s.n_trials)
        np.testing.assert_allclose(ys_b[:, b].numpy(), ys_s.numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_batched_api_errors():
    f = _f_t
    w = (torch.tensor(W),)
    with pytest.raises(ValueError, match="rank-0"):
        todeint(f, torch.tensor(1.0), TS, w, batch_axis=0)
    with pytest.raises(ValueError, match="per-row h0"):
        todeint(f, torch.tensor(_hetero_batch()), TS, w, batch_axis=0,
                h0=torch.full((3,), 1e-2))
    with pytest.raises(ValueError, match="slice B"):
        todeint(f, torch.tensor(_hetero_batch()), TS, w, batch_axis=0,
                grad_method="adjoint")
    with pytest.raises(ValueError, match="slice D"):
        todeint(f, torch.tensor(_hetero_batch()), TS, w, batch_axis=0,
                checkpoint_segments=4)
