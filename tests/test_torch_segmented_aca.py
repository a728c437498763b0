"""Segmented (O(K)-state) ACA of the port, mirroring
``tests/test_segmented_aca.py``.

``checkpoint_segments=K`` keeps K state snapshots; the backward
re-integrates each segment from its snapshot with the saved stepsizes and
the saved k0 carry, so every replayed ψ starts from the forward's state.
The port runs eagerly with one accumulation order, so inside the port the
segmented gradients are held **bitwise** to the full buffer's, on both
stepper paths, solo and batched, for dopri5, bosh3 and heun_euler (the
reference holds its batched plain path to 1e-5 only: XLA fuses the
replay differently from the forward). Against the reference (JAX on the
CPU, Pallas in interpret mode) the same numpy inputs give equal step
counts and gradients within rtol=1e-5, atol=1e-7, the reference test's
own tolerance for its near-exact case.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import odeint as jodeint
from repro.kernels import ops as jops
from repro_torch.core import odeint as todeint
from repro_torch.core import resolve_checkpoint_segments
from repro_torch.core.controller import ControllerConfig
from repro_torch.core.integrate import (
    adaptive_while_solve,
    batched_adaptive_while_solve,
    resolve_segmentation,
    segment_length,
)
from repro_torch.core.odeint_aca import _reintegrate, _Problem
from repro_torch.core.stepper import maybe_flatten
from repro_torch.core.tableaus import get_tableau

MAX_STEPS = 48
TS = (0.0, 0.6, 1.3)
SOLO_TOL = {"dopri5": 1e-7, "bosh3": 1e-6, "heun_euler": 1e-4}
BATCHED_CFG = {"dopri5": (1e-4, 64), "bosh3": (1e-4, 64),
               "heun_euler": (1e-3, 96)}
SOLVERS = ["dopri5", "bosh3", "heun_euler"]
SEGMENTS = [1, 3, "auto"]
REF_RTOL, REF_ATOL = 1e-5, 1e-7


@pytest.fixture(scope="module", autouse=True)
def _interpret_kernels():
    jops.set_interpret(True)
    yield
    jops.set_interpret(None)


def _assert_bitequal(a, b, what=""):
    for x, y in zip(a, b):
        assert torch.equal(x, y), what


# ---------------------------------------------------------------- solo --

def _solo_inputs():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((5, 5)) * 0.5).astype(np.float32)
    x = rng.standard_normal(5).astype(np.float32)
    y = rng.standard_normal((3, 2)).astype(np.float32)
    return w, x, y


def _f_solo_t(t, z, w):
    return {"x": torch.tanh(w @ z["x"]) - 0.3 * z["x"],
            "y": -0.5 * z["y"] + 0.1 * torch.sin(z["y"]) * z["x"][:2][None]}


def _f_solo_j(t, z, w):
    return {"x": jnp.tanh(w @ z["x"]) - 0.3 * z["x"],
            "y": -0.5 * z["y"] + 0.1 * jnp.sin(z["y"]) * z["x"][:2][None]}


@functools.lru_cache(maxsize=None)
def _solo_grads(solver, use_pallas, segments, max_steps=MAX_STEPS):
    """The port's (dL/dx, dL/dy, dL/dw) and stats."""
    w, x, y = (torch.tensor(a, requires_grad=True) for a in _solo_inputs())
    tol = SOLO_TOL[solver]
    ys, stats = todeint(_f_solo_t, {"x": x, "y": y}, torch.tensor(TS),
                        (w,), solver=solver, rtol=tol, atol=tol,
                        max_steps=max_steps, use_pallas=use_pallas,
                        checkpoint_segments=segments)
    loss = (ys["x"][-1] ** 2).sum() + (ys["y"][1] ** 3).sum()
    return torch.autograd.grad(loss, [x, y, w]), stats


@functools.lru_cache(maxsize=None)
def _solo_grads_ref(solver, segments, max_steps=MAX_STEPS):
    w, x, y = (jnp.asarray(a) for a in _solo_inputs())
    tol = SOLO_TOL[solver]

    def loss(z0, w):
        ys, stats = jodeint(_f_solo_j, z0, jnp.asarray(TS), (w,),
                            solver=solver, rtol=tol, atol=tol,
                            max_steps=max_steps,
                            checkpoint_segments=segments)
        return (ys["x"][-1] ** 2).sum() + (ys["y"][1] ** 3).sum(), stats

    (_, stats), (gz, gw) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)({"x": x, "y": y}, w)
    return [np.asarray(g) for g in (gz["x"], gz["y"], gw)], stats


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("segments", SEGMENTS)
def test_solo_grads_bitmatch_full_buffer(solver, use_pallas, segments):
    g_full, stats = _solo_grads(solver, use_pallas, None)
    g_seg, stats_seg = _solo_grads(solver, use_pallas, segments)
    assert int(stats.n_steps) > 4  # the grid is long enough to segment
    assert int(stats_seg.n_steps) == int(stats.n_steps)
    _assert_bitequal(g_seg, g_full,
                     f"{solver}/pallas={use_pallas}/K={segments}")


@pytest.mark.parametrize("solver", SOLVERS)
def test_solo_segmented_grads_match_reference(solver):
    """The port's segmented gradients against ``jax.grad`` of the
    reference's segmented solve, K = "auto"."""
    g_t, st_t = _solo_grads(solver, False, "auto")
    g_j, st_j = _solo_grads_ref(solver, "auto")
    assert int(st_t.n_steps) == int(st_j.n_steps)
    for a, b in zip(g_t, g_j):
        np.testing.assert_allclose(a.numpy(), b, rtol=REF_RTOL,
                                   atol=REF_ATOL)


def test_solo_bosh3_auto_bitmatch():
    """The reference's bosh3 case on the fused path as well: the K1/K2
    path's segmented sweep is its full buffer's bit for bit."""
    _assert_bitequal(_solo_grads("bosh3", True, "auto")[0],
                     _solo_grads("bosh3", True, None)[0])


def test_K_at_least_max_steps_is_the_full_buffer():
    # seg_len == 1 delegates to the full sweep; oversized K clamps first
    for K in (MAX_STEPS, 10_000):
        _assert_bitequal(_solo_grads("dopri5", False, K)[0],
                         _solo_grads("dopri5", False, None)[0])


def test_reintegrated_states_are_the_forward_states():
    """The re-integration (K1 with the ``b`` row on the fused path, no
    error norm) repeats the forward's accepted states (K2's z_next there)
    bit for bit, with the re-chained k0 carry, for an FSAL and a non-FSAL
    pair on both stepper paths."""
    w, x, y = (torch.tensor(a) for a in _solo_inputs())
    cfg = ControllerConfig(max_steps=MAX_STEPS)
    for solver in ("dopri5", "heun_euler"):
        tab = get_tableau(solver)
        tol = SOLO_TOL[solver]
        for up in (False, True):
            # the pytree state is raveled on both paths
            f, z0, _, up2 = maybe_flatten(_f_solo_t, {"x": x, "y": y}, up)
            _, full, _ = adaptive_while_solve(tab, f, z0, torch.tensor(TS),
                                              (w,), tol, tol, cfg,
                                              use_pallas=up2)
            _, seg, _ = adaptive_while_solve(tab, f, z0, torch.tensor(TS),
                                             (w,), tol, tol, cfg,
                                             use_pallas=up2,
                                             checkpoint_segments=1)
            assert torch.equal(seg.z[0], full.z[0])
            prob = _Problem(tab, f, tol, tol, cfg, None, up2, None)
            z, k0 = seg.z[0], seg.k0[0]
            for i in range(1, full.n):
                z, k0 = _reintegrate(prob, (w,), seg, z, k0, i - 1,
                                     seg.h[i - 1], batched=False)
                assert torch.equal(z, full.z[i]), (solver, up, i)


# ------------------------------------------------------------- batched --

def _batched_inputs(B=4, d=8):
    rng = np.random.default_rng(1)
    x0 = rng.standard_normal((B, d - 1))
    logk = np.linspace(0.0, 2.5, B)  # stiffness spread -> ragged grids
    z0 = np.concatenate([x0, logk[:, None]], axis=1).astype(np.float32)
    w = (rng.standard_normal((d - 1, d - 1)) * 0.3).astype(np.float32)
    return z0, w


def _f_batched_t(t, z, w):
    x, logk = z[:-1], z[-1]
    dx = -torch.exp(logk) * x + 0.1 * torch.tanh(w @ x)
    return torch.cat([dx, torch.zeros(1, dtype=z.dtype)])


def _f_batched_j(t, z, w):
    x, logk = z[:-1], z[-1]
    dx = -jnp.exp(logk) * x + 0.1 * jnp.tanh(w @ x)
    return jnp.concatenate([dx, jnp.zeros((1,), z.dtype)])


@functools.lru_cache(maxsize=None)
def _batched_grads(solver, use_pallas, segments):
    z0, w = (torch.tensor(a, requires_grad=True)
             for a in _batched_inputs())
    tol, max_steps = BATCHED_CFG[solver]
    ys, stats = todeint(_f_batched_t, z0, torch.tensor(TS), (w,),
                        solver=solver, batch_axis=0, rtol=tol, atol=tol,
                        max_steps=max_steps, use_pallas=use_pallas,
                        checkpoint_segments=segments)
    loss = (ys[-1] ** 2).sum() + (ys[1] ** 3).sum()
    return torch.autograd.grad(loss, [z0, w]), stats


@functools.lru_cache(maxsize=None)
def _batched_grads_ref(solver, segments):
    z0, w = (jnp.asarray(a) for a in _batched_inputs())
    tol, max_steps = BATCHED_CFG[solver]

    def loss(z0, w):
        ys, stats = jodeint(_f_batched_j, z0, jnp.asarray(TS, jnp.float32),
                            (w,), solver=solver, batch_axis=0, rtol=tol,
                            atol=tol, max_steps=max_steps,
                            checkpoint_segments=segments)
        return (ys[-1] ** 2).sum() + (ys[1] ** 3).sum(), stats

    (_, stats), g = jax.value_and_grad(loss, argnums=(0, 1),
                                       has_aux=True)(z0, w)
    return [np.asarray(x) for x in g], stats


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("segments", SEGMENTS)
def test_batched_pallas_grads_bitmatch(solver, segments):
    g_full, stats = _batched_grads(solver, True, None)
    g_seg, _ = _batched_grads(solver, True, segments)
    # ragged per-row grids, or the end-aligned replay is not exercised
    assert len(set(stats.n_steps.tolist())) > 1
    _assert_bitequal(g_seg, g_full, f"{solver}/K={segments}")


@pytest.mark.parametrize("segments", SEGMENTS)
def test_batched_pytree_grads_near_exact(segments):
    """The reference holds its batched plain path to 1e-5 (XLA fuses the
    replay's field differently); the port's is bitwise, and within the
    reference test's tolerance of the reference's gradients."""
    g_full, st = _batched_grads("dopri5", False, None)
    g_seg, _ = _batched_grads("dopri5", False, segments)
    _assert_bitequal(g_seg, g_full, f"K={segments}")
    g_ref, st_ref = _batched_grads_ref("dopri5", segments)
    np.testing.assert_array_equal(st.n_steps.numpy(),
                                  np.asarray(st_ref.n_steps))
    for a, b in zip(g_seg, g_ref):
        np.testing.assert_allclose(a.numpy(), b, rtol=REF_RTOL,
                                   atol=REF_ATOL)


@pytest.mark.parametrize("solver", ["heun_euler", "bosh3"])
def test_batched_heun_euler_pytree_bitmatch(solver):
    g_full, _ = _batched_grads(solver, False, None)
    g_seg, _ = _batched_grads(solver, False, "auto")
    _assert_bitequal(g_seg, g_full)


# ------------------------------------------------- overflow / raggedness --

def test_overflow_still_bitmatches_full_buffer():
    """The solve running out of accepted steps: both buffers hold the same
    truncated grid and the gradients agree bit for bit."""
    g_full, stats_full = _solo_grads("dopri5", False, None, max_steps=3)
    g_seg, stats_seg = _solo_grads("dopri5", False, 2, max_steps=3)
    assert bool(stats_full.overflow) and bool(stats_seg.overflow)
    _assert_bitequal(g_seg, g_full)


# ------------------------------------------------------- plumbing/shapes --

def test_snapshot_buffer_shapes():
    tab = get_tableau("dopri5")
    cfg = ControllerConfig(max_steps=32, max_trials=12)
    w, x, y = (torch.tensor(a) for a in _solo_inputs())
    f, z0, _, _ = maybe_flatten(_f_solo_t, {"x": x, "y": y}, True)
    _, ck, _ = adaptive_while_solve(tab, f, z0, torch.tensor(TS), (w,),
                                    1e-4, 1e-4, cfg, checkpoint_segments=4)
    assert ck.z.shape == (4, 11) and ck.k0.shape == (4, 11)
    assert ck.t.shape == (32,)  # the scalar grids keep every step

    z0b, wb = (torch.tensor(a) for a in _batched_inputs())
    _, ckb, _ = batched_adaptive_while_solve(
        tab, _f_batched_t, z0b, torch.tensor(TS), (wb,), 1e-4, 1e-4, cfg,
        checkpoint_segments=4)
    assert ckb.z.shape == (4, 4, 8) and ckb.k0.shape == (4, 4, 8)
    assert ckb.t.shape == (4, 32)


def test_resolve_checkpoint_segments():
    assert resolve_checkpoint_segments(None, 64) is None
    assert resolve_checkpoint_segments("auto", 64) == 8
    assert resolve_checkpoint_segments("auto", 50) == 8  # ceil(sqrt)
    assert resolve_checkpoint_segments("auto", 32) == 6  # node18's
    assert resolve_checkpoint_segments(200, 64) == 64    # clamped
    with pytest.raises(ValueError):
        resolve_checkpoint_segments(0, 64)
    for max_steps in (7, 32, 50, 64):
        for K in (1, 2, 3, 5, max_steps):
            assert K * segment_length(K, max_steps) >= max_steps
    assert resolve_segmentation(None, 64) == (None, None)
    assert resolve_segmentation(64, 64) == (None, None)
    assert resolve_segmentation(8, 64) == (8, 8)
    assert resolve_segmentation("auto", 32) == (6, 6)


def test_rejected_for_non_aca_and_fixed_solvers():
    w, x, y = (torch.tensor(a) for a in _solo_inputs())
    for kw in (dict(grad_method="adjoint"), dict(grad_method="naive"),
               dict(solver="rk4")):
        with pytest.raises(ValueError, match="checkpoint_segments"):
            todeint(_f_solo_t, {"x": x, "y": y}, torch.tensor(TS), (w,),
                    checkpoint_segments=4, **kw)
