"""The adjoint, naive and mali methods under ``batch_axis=0``, and every
method's fixed grid and reverse time: the method-parametrized cases of
``tests/test_batched_solve.py`` and ``tests/test_time_handling.py``'s
descending-``ts`` case, for aca, adjoint and naive, and their mali cases
(the ALF pair integrator: no tableau, no fixed grid, a larger step
budget, as the reference's ``_kw`` gives it).

The same numpy inputs go through the reference (JAX on the CPU, Pallas in
interpret mode) and the port (the kernels' plain versions on the CPU),
with the reference test's heterogeneous batch: per-row stiffness
exp(logk) rides inside the state, so one shared ``w`` still gives every
row its own grid. Tolerances:

* port against reference, both batched: per-row accepted steps equal,
  ``ys`` and the gradients of z0 and w within rtol=1e-5 and atol=1e-7
  (w: 1e-6), the reference's batched-vs-vmap bounds;
* port batched row b against the port's solo solve of row b: accepted
  steps and trials equal, ``ys`` and gradients within the same bounds;
* fixed grids, batched against per-row solo: ``ys`` rtol=1e-6 atol=1e-7,
  gradients rtol=1e-5 atol=1e-7 (the reference test's);
* descending ``ts`` against the hand-negated ascending problem: ``ys``
  bitwise, gradients within 1e-6 of their scale (the reference test's);
* mali batched against the port's solo rows: the same bounds, outputs
  bit for bit; against the reference, its statuses and steps (see
  ``test_mali_matches_reference_and_solo_rows``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from repro.core import odeint as jodeint
from repro.kernels import ops as jops
from repro_torch.core import odeint as todeint

TS = [0.0, 0.5, 1.0]
KW = dict(solver="dopri5", rtol=1e-5, atol=1e-5, max_steps=64)
W = np.float32(0.7)
# the ACA cases of tests that test_torch_batched_solve.py holds already
BASELINES = ("adjoint", "naive")
# the RK-tableau methods; mali's cases are the tests named for it
RK_METHODS = ("aca", "adjoint", "naive")
MALI_KW = dict(solver=None, rtol=1e-5, atol=1e-5, max_steps=2048)
# against the reference mali runs at 1e-4: at 1e-5 the non-dissipative
# ALF's stepsize on the stiffer rows follows rounding noise (row 1 of the
# heterogeneous batch takes 356 steps here, 368 in the reference; ROADMAP
# queue 3)
MALI_REF_TOL = dict(rtol=1e-4, atol=1e-4)


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


@pytest.fixture(autouse=True)
def _interpret_kernels():
    jops.set_interpret(True)
    yield
    jops.set_interpret(None)


def _port_case(method, z0, use_pallas, **kw):
    zz = torch.tensor(z0, requires_grad=True)
    ww = torch.tensor(W, requires_grad=True)
    ys, st = todeint(_f_t, zz, TS, (ww,), grad_method=method,
                     use_pallas=use_pallas, **{**KW, **kw})
    torch.sum(ys[-1] ** 2).backward()
    return ys.detach().numpy(), st, zz.grad.numpy(), ww.grad.numpy()


@functools.lru_cache(maxsize=None)
def _ref_case(method, use_pallas):
    z0 = _hetero_batch()

    def loss(w, z0):
        ys, st = jodeint(_f_j, z0, jnp.asarray(TS, jnp.float32), (w,),
                         grad_method=method, batch_axis=0,
                         use_pallas=use_pallas, **KW)
        return jnp.sum(ys[-1] ** 2), (ys, st)

    (_, (ys, st)), (gw, gz) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(jnp.float32(W), jnp.asarray(z0))
    stats = {k: np.asarray(v) for k, v in st._asdict().items()}
    return np.asarray(ys), stats, np.asarray(gz), np.asarray(gw)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("method", BASELINES)
def test_matches_reference_batched(method, use_pallas):
    """Port batch_axis=0 against reference batch_axis=0: the same per-row
    grids, outputs and gradients (the ACA cases are in
    test_torch_batched_solve.py). The naive method reports the trials it
    took, within the reference's budget."""
    z0 = _hetero_batch()
    ys_t, st_t, gz_t, gw_t = _port_case(method, z0, use_pallas,
                                        batch_axis=0)
    ys_j, st_j, gz_j, gw_j = _ref_case(method, use_pallas)
    fields = ["n_steps", "status", "overflow"]
    if method == "adjoint":
        fields += ["n_trials", "nfe"]
    else:
        assert (st_t.n_trials.numpy() <= st_j["n_trials"]).all()
    for field in fields:
        np.testing.assert_array_equal(getattr(st_t, field).numpy(),
                                      st_j[field], err_msg=field)
    assert len(np.unique(st_t.n_steps.numpy())) > 1
    np.testing.assert_allclose(ys_t, ys_j, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(gz_t, gz_j, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(gw_t, gw_j, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("method", BASELINES)
def test_matches_solo_rows(method, use_pallas):
    """batch_axis=0 against the port's solo solve of each row (the
    reference's vmap-of-solo test): every row on its own grid, with the
    solo solve's steps and trials; the shared w's gradient is the sum of
    the rows'."""
    z0 = _hetero_batch()
    ys_b, st_b, gz_b, gw_b = _port_case(method, z0, use_pallas,
                                        batch_axis=0)
    gw_s = 0.0
    for b in range(z0.shape[0]):
        ys_s, st_s, gz_s, gw = _port_case(method, z0[b], use_pallas)
        assert int(st_b.n_steps[b]) == int(st_s.n_steps)
        assert int(st_b.n_trials[b]) == int(st_s.n_trials)
        np.testing.assert_allclose(ys_b[:, b], ys_s, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(gz_b[b], gz_s, rtol=1e-5, atol=1e-7)
        gw_s = gw_s + gw
    assert len(np.unique(st_b.n_steps.numpy())) > 1
    np.testing.assert_allclose(gw_b, gw_s, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("method", BASELINES)
def test_finished_elements_freeze_bit_stable(method):
    """A stiff straggler added to the batch leaves the easy rows' outputs
    and stats bit-identical."""
    z_easy = _hetero_batch(B=2)
    stiff = np.concatenate([np.ones((1, 3)) * 0.5, np.full((1, 1), 4.2)],
                           axis=1).astype(np.float32)
    z_more = np.concatenate([z_easy, stiff], axis=0)
    ys2, st2 = todeint(_f_t, torch.tensor(z_easy), TS, (torch.tensor(W),),
                       grad_method=method, batch_axis=0, **KW)
    ys3, st3 = todeint(_f_t, torch.tensor(z_more), TS, (torch.tensor(W),),
                       grad_method=method, batch_axis=0, **KW)
    assert int(st3.n_steps[2]) > int(st3.n_steps[:2].max())
    assert torch.equal(ys2, ys3[:, :2])
    for a, b in zip(st2, st3):
        assert torch.equal(a, b[:2])


@pytest.mark.parametrize("method", RK_METHODS)
def test_fixed_grid_batched(method):
    """A fixed grid is shared exactly: batch_axis=0 equals the per-row
    solo fixed-grid solves, with (B,)-broadcast stats."""
    z0 = _hetero_batch(B=3)
    kw = dict(solver="rk4", grad_method=method, steps_per_interval=8)
    zz = torch.tensor(z0, requires_grad=True)
    ys_b, st_b = todeint(_f_t, zz, TS, (torch.tensor(W),), batch_axis=0,
                         **kw)
    torch.sum(ys_b[-1] ** 2).backward()
    assert st_b.n_steps.shape == (3,) and st_b.status.shape == (3,)
    assert (st_b.n_steps == 16).all()
    for b in range(3):
        zb = torch.tensor(z0[b], requires_grad=True)
        ys_s, _ = todeint(_f_t, zb, TS, (torch.tensor(W),), **kw)
        torch.sum(ys_s[-1] ** 2).backward()
        np.testing.assert_allclose(ys_b[:, b].detach().numpy(),
                                   ys_s.detach().numpy(), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(zz.grad[b].numpy(), zb.grad.numpy(),
                                   rtol=1e-5, atol=1e-7)


def _pair_t(t, z, w):
    return {"a": -1.5 * z["a"] + 0.1 * torch.tanh(w * z["b"]),
            "b": -0.5 * z["b"]}


def _pair_j(t, z, w):
    return {"a": -1.5 * z["a"] + 0.1 * jnp.tanh(w * z["b"]),
            "b": -0.5 * z["b"]}


@pytest.mark.parametrize("method", RK_METHODS)
def test_pytree_state_batched(method):
    """Dict states batch too: raveled per sample into one (B, N) state on
    both paths; the fused path is the plain one bit for bit forward, and
    both match the reference's batched solve."""
    rng = np.random.default_rng(2)
    a0 = rng.standard_normal((3, 4)).astype(np.float32)
    b0 = rng.standard_normal((3, 4)).astype(np.float32)
    outs = {}
    for up in (False, True):
        wt = torch.tensor(W, requires_grad=True)
        ys, st = todeint(_pair_t, {"a": torch.tensor(a0),
                                   "b": torch.tensor(b0)}, TS, (wt,),
                         grad_method=method, batch_axis=0, use_pallas=up,
                         **KW)
        sum(torch.sum(v[-1] ** 2) for v in ys.values()).backward()
        outs[up] = ({k: v.detach() for k, v in ys.items()}, float(wt.grad),
                    st)
    for k in ("a", "b"):
        assert outs[False][0][k].shape == (len(TS), 3, 4)
        assert torch.equal(outs[False][0][k], outs[True][0][k])
    assert abs(outs[True][1] - outs[False][1]) <= 1e-5 * abs(outs[False][1])

    def loss(w):
        ys, st = jodeint(_pair_j, {"a": jnp.asarray(a0),
                                   "b": jnp.asarray(b0)},
                         jnp.asarray(TS, jnp.float32), (w,),
                         grad_method=method, batch_axis=0, **KW)
        return sum(jnp.sum(v[-1] ** 2) for v in ys.values()), (ys, st)

    (_, (ys_r, st_r)), g_r = jax.value_and_grad(loss, has_aux=True)(
        jnp.float32(W))
    np.testing.assert_array_equal(outs[False][2].n_steps.numpy(),
                                  np.asarray(st_r.n_steps))
    for k in ("a", "b"):
        np.testing.assert_allclose(outs[False][0][k].numpy(),
                                   np.asarray(ys_r[k]), rtol=1e-5, atol=1e-7)
    assert abs(outs[False][1] - float(g_r)) <= 1e-5 * abs(float(g_r))


@pytest.mark.parametrize("method", BASELINES)
def test_per_row_tolerances(method):
    """(B,) tolerances under the adjoint and naive methods: a row at
    tolerance τ takes the steps of the all-τ batch's row, forward and
    (for the adjoint) in the reverse solve."""
    z0 = _hetero_batch()
    tols = torch.tensor([1e-3, 1e-5, 1e-3, 1e-5])
    kw = dict(solver="dopri5", max_steps=64, batch_axis=0)
    _, st, gz, _ = _port_case(method, z0, False, rtol=tols, atol=tols, **kw)
    for tau in (1e-3, 1e-5):
        _, st_s, gz_s, _ = _port_case(method, z0, False, rtol=tau, atol=tau,
                                      **kw)
        rows = (tols == tau).numpy()
        np.testing.assert_array_equal(st.n_steps.numpy()[rows],
                                      st_s.n_steps.numpy()[rows])
        np.testing.assert_array_equal(gz[rows], gz_s[rows])


# ------------------------------------------------- reverse-time solving

def _field(t, z, w):
    return torch.tanh(w @ z) * (0.6 + 0.4 * torch.cos(t))


def _reverse_case(method, use_pallas, batched):
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((6, 6)) * 0.4).astype(np.float32)
    z0 = rng.standard_normal(6).astype(np.float32)
    kw = dict(solver="dopri5", grad_method=method, rtol=1e-6, atol=1e-6,
              max_steps=128, use_pallas=use_pallas)
    if method == "mali":
        # the ALF pair integrator: no tableau, a larger step budget
        kw.update(solver=None, max_steps=4096)
    field = _field
    if batched:
        z0 = np.stack([z0, 1.5 * z0, -0.5 * z0])
        kw["batch_axis"] = 0
    ts_desc = torch.linspace(1.0, 0.0, 5)
    out = []
    for f, ts in ((field, ts_desc),
                  # the hand-negated ascending problem
                  (lambda s, z, ww: pytree.tree_map(torch.neg,
                                                    field(-s, z, ww)),
                   -ts_desc)):
        wt = torch.tensor(w, requires_grad=True)
        ys, _ = todeint(f, torch.tensor(z0), ts, (wt,), **kw)
        torch.sum(ys ** 2).backward()
        out += [ys.detach(), wt.grad]
    return out


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("method", RK_METHODS)
def test_descending_equals_negated_ascending(method, use_pallas, batched):
    ys_d, g_d, ys_n, g_n = _reverse_case(method, use_pallas, batched)
    assert torch.equal(ys_d, ys_n)
    scale = max(float(g_n.abs().max()), 1e-12)
    assert float((g_d - g_n).abs().max()) / scale <= 1e-6, method


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("use_pallas", [False, True])
def test_mali_descending_equals_negated_ascending(use_pallas, batched):
    """``tests/test_time_handling.py``'s mali case: descending ``ts`` is
    the hand-negated ascending solve, ys bitwise, gradients within 1e-6
    of their scale."""
    ys_d, g_d, ys_n, g_n = _reverse_case("mali", use_pallas, batched)
    assert torch.equal(ys_d, ys_n)
    scale = max(float(g_n.abs().max()), 1e-12)
    assert float((g_d - g_n).abs().max()) / scale <= 1e-6


@functools.lru_cache(maxsize=None)
def _ref_mali_stats(use_pallas):
    _, st = jodeint(_f_j, jnp.asarray(_hetero_batch()),
                    jnp.asarray(TS, jnp.float32), (jnp.float32(W),),
                    grad_method="mali", batch_axis=0, use_pallas=use_pallas,
                    **{**MALI_KW, **MALI_REF_TOL})
    return {k: np.asarray(v) for k, v in st._asdict().items()}


@pytest.mark.parametrize("use_pallas", [False, True])
def test_mali_matches_reference_and_solo_rows(use_pallas):
    """``tests/test_batched_solve.py``'s mali case: every row of the
    heterogeneous batch on its own grid and lattice, with the port's solo
    solve's steps, trials and outputs (bit for bit) and gradients (the
    bounds above). Against the reference at 1e-4 the statuses and
    overflows are equal and the steps within one: the two stiff rows
    spend the 2048-step budget in both, and row 1's ALF stepsize sits at
    its stability limit, where the accept decisions follow the fields'
    rounding (134 steps here, 135 in the reference; ROADMAP queue 3).
    The reference's outputs and gradients on a non-stiff batch are held in
    ``tests/test_torch_mali.py::test_mali_matches_reference_vdp``."""
    z0 = _hetero_batch()
    ys_b, st_b, gz_b, gw_b = _port_case("mali", z0, use_pallas,
                                        batch_axis=0, **MALI_KW)
    assert len(np.unique(st_b.n_steps.numpy())) > 1
    gw_s = 0.0
    for b in range(z0.shape[0]):
        ys_s, st_s, gz_s, gw = _port_case("mali", z0[b], use_pallas,
                                          **MALI_KW)
        assert int(st_b.n_steps[b]) == int(st_s.n_steps)
        assert int(st_b.n_trials[b]) == int(st_s.n_trials)
        np.testing.assert_array_equal(ys_b[:, b], ys_s)
        np.testing.assert_allclose(gz_b[b], gz_s, rtol=1e-5, atol=1e-7)
        gw_s = gw_s + gw
    np.testing.assert_allclose(gw_b, gw_s, rtol=1e-5, atol=1e-6)
    _, st_q, _, _ = _port_case("mali", z0, use_pallas, batch_axis=0,
                               **{**MALI_KW, **MALI_REF_TOL})
    st_j = _ref_mali_stats(use_pallas)
    for field in ("status", "overflow"):
        np.testing.assert_array_equal(getattr(st_q, field).numpy(),
                                      st_j[field], err_msg=field)
    assert np.abs(st_q.n_steps.numpy() - st_j["n_steps"]).max() <= 1


def test_mali_finished_elements_freeze_bit_stable():
    """A stiffer row added to the batch leaves the others' outputs and
    stats bit-identical; inside ALF's stiffness range, as the reference's
    mali case (ALF cannot damp, so very stiff rows pin its stepsize)."""
    x0 = np.random.default_rng(1).standard_normal((3, 3))
    logk = np.array([0.0, 1.2, 1.6])
    z_more = np.concatenate([x0, logk[:, None]], axis=1).astype(np.float32)
    z_easy = z_more[:2]
    kw = dict(grad_method="mali", batch_axis=0, **MALI_KW)
    ys2, st2 = todeint(_f_t, torch.tensor(z_easy), TS, (torch.tensor(W),),
                       **kw)
    ys3, st3 = todeint(_f_t, torch.tensor(z_more), TS, (torch.tensor(W),),
                       **kw)
    assert int(st3.n_steps[2]) > int(st3.n_steps[:2].max())
    assert torch.equal(ys2, ys3[:, :2])
    for a, b in zip(st2, st3):
        assert torch.equal(a, b[:2])


def test_mali_pytree_state_batched():
    """A dict state batched under mali at 1e-4: the fused path's forward
    is the plain path's bit for bit (the lattice step is integer
    arithmetic on both), gradients within 1e-5, steps the reference's."""
    rng = np.random.default_rng(2)
    a0 = rng.standard_normal((3, 4)).astype(np.float32)
    b0 = rng.standard_normal((3, 4)).astype(np.float32)
    outs = {}
    for up in (False, True):
        wt = torch.tensor(W, requires_grad=True)
        ys, st = todeint(_pair_t, {"a": torch.tensor(a0),
                                   "b": torch.tensor(b0)}, TS, (wt,),
                         grad_method="mali", batch_axis=0, use_pallas=up,
                         **{**MALI_KW, **MALI_REF_TOL})
        sum(torch.sum(v[-1] ** 2) for v in ys.values()).backward()
        outs[up] = ({k: v.detach() for k, v in ys.items()}, float(wt.grad),
                    st)
    for k in ("a", "b"):
        assert outs[False][0][k].shape == (len(TS), 3, 4)
        assert torch.equal(outs[False][0][k], outs[True][0][k])
    assert abs(outs[True][1] - outs[False][1]) <= 1e-5 * abs(outs[False][1])
    _, st_r = jodeint(_pair_j, {"a": jnp.asarray(a0), "b": jnp.asarray(b0)},
                      jnp.asarray(TS, jnp.float32), (jnp.float32(W),),
                      grad_method="mali", batch_axis=0,
                      **{**MALI_KW, **MALI_REF_TOL})
    np.testing.assert_array_equal(outs[False][2].n_steps.numpy(),
                                  np.asarray(st_r.n_steps))
