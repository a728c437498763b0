"""The port's datasets (``repro_torch.data``) against the reference's
``repro.data`` on the same seeds.

* ``spiral_classification`` and ``irregular_series_batch``: bitwise,
  over several seeds and sizes (both draw with numpy's ``default_rng``;
  the second mirrors ``tests/test_sharding_and_cost.py``'s shape test).
* ``merged_time_grid``: the roundtrip of ``tests/test_dense_output.py``,
  and bitwise the reference's grid in f32 and f64.
* ``three_body_rhs``: within 1e-6 of max |value| (the port's f32 ops in
  the reference's order).
* ``simulate_three_body``: the eval times bitwise; the trajectory, not
  the accepted grid (at rtol 1e-8 in f32 the error estimate sits at the
  field's rounding, so the grids follow rounding noise): over [0, 0.5]
  at rtol 1e-9 within 1e-6 of the reference (both lie ~3e-7 from an f64
  solve), energy conserved within 1e-3 as the reference test holds it;
  over [0, 2] at rtol 1e-8 (the benchmark's ground truth, where a close
  approach amplifies every rounding) no farther from the reference than
  the reference lies from an f64 solve at 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import irregular_series_batch as j_series
from repro.data import merged_time_grid as j_grid
from repro.data import spiral_classification as j_spiral
from repro.data.threebody import simulate_three_body as j_simulate
from repro.data.threebody import three_body_rhs as j_rhs
from repro_torch.core import odeint
from repro_torch.data import irregular_series_batch as t_series
from repro_torch.data import merged_time_grid as t_grid
from repro_torch.data import spiral_classification as t_spiral
from repro_torch.data.threebody import simulate_three_body as t_simulate
from repro_torch.data.threebody import three_body_rhs as t_rhs


@pytest.mark.parametrize("n,classes,dim,seed,lift_seed",
                         [(400, 3, 16, 0, 0), (300, 3, 16, 7, 0),
                          (101, 4, 5, 3, 2), (64, 2, 16, 11, 5)])
def test_spiral_classification_bitwise(n, classes, dim, seed, lift_seed):
    xj, yj = j_spiral(n, n_classes=classes, dim=dim, seed=seed,
                      lift_seed=lift_seed)
    xt, yt = t_spiral(n, n_classes=classes, dim=dim, seed=seed,
                      lift_seed=lift_seed, device="cpu")
    assert xt.dtype == torch.float32 and xt.shape == xj.shape
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(yt.numpy(), np.asarray(yj))


@pytest.mark.parametrize("batch,n_obs,obs_dim,latent,seed",
                         [(3, 12, 5, 4, 1), (48, 16, 8, 4, 0),
                          (16, 16, 8, 4, 99), (2, 3, 2, 3, 5)])
def test_irregular_series_bitwise(batch, n_obs, obs_dim, latent, seed):
    bj = j_series(batch=batch, n_obs=n_obs, obs_dim=obs_dim,
                  latent_dim=latent, seed=seed)
    bt = t_series(batch=batch, n_obs=n_obs, obs_dim=obs_dim,
                  latent_dim=latent, seed=seed, device="cpu")
    assert bt["ts"].shape == (batch, n_obs)
    assert bt["ys"].shape == (batch, n_obs, obs_dim)
    assert bool((torch.diff(bt["ts"], dim=1) >= 0).all())
    for key in ("ts", "ys", "mask"):
        assert bt[key].dtype == torch.float32
        np.testing.assert_array_equal(bt[key].numpy(), np.asarray(bj[key]))


def test_merged_time_grid_roundtrip():
    ts = torch.tensor([[0.0, 0.5, 1.0], [0.0, 0.25, 1.0]])
    grid = t_grid(ts)
    tu, idx = grid["t_union"].numpy(), grid["idx"].numpy()
    assert (np.diff(tu) > 0).all()          # strictly increasing
    np.testing.assert_array_equal(tu[idx], ts.numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_merged_time_grid_matches_reference(dtype):
    """Cast before deduplicating: times 1e-9 apart are one f32 knot and
    two f64 knots, as in the reference (f64 there under x64)."""
    ts = np.array([[0.0, 0.3, 0.3 + 1e-9, 2.0], [0.0, 0.1, 0.3, 1.5]])
    grid = t_grid(torch.tensor(ts, dtype=torch.float64), dtype=dtype)
    if dtype == torch.float64:
        with jax.enable_x64(True):
            ref = j_grid(ts)
            tu_j, idx_j = np.asarray(ref["t_union"]), np.asarray(ref["idx"])
    else:
        ref = j_grid(ts)
        tu_j, idx_j = np.asarray(ref["t_union"]), np.asarray(ref["idx"])
    assert grid["t_union"].dtype == dtype
    assert len(tu_j) == (6 if dtype == torch.float64 else 5)
    np.testing.assert_array_equal(grid["t_union"].numpy(), tu_j)
    np.testing.assert_array_equal(grid["idx"].numpy(), idx_j)


def test_three_body_rhs_matches_reference():
    rng = np.random.default_rng(4)
    for _ in range(3):
        r = rng.normal(size=(3, 3)).astype(np.float32)
        v = rng.normal(size=(3, 3)).astype(np.float32)
        m = rng.uniform(0.5, 1.5, 3).astype(np.float32)
        oj = j_rhs(0.0, {"r": jnp.asarray(r), "v": jnp.asarray(v)},
                   jnp.asarray(m))
        ot = t_rhs(0.0, {"r": torch.tensor(r), "v": torch.tensor(v)},
                   torch.tensor(m))
        for key in ("r", "v"):
            a, b = ot[key].numpy(), np.asarray(oj[key])
            assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max(), key


def _energy(r, v, m):
    ke = 0.5 * torch.sum(m[:, None] * v ** 2)
    diff = r[:, None, :] - r[None, :, :]
    eye = torch.eye(3, dtype=r.dtype)
    dist = torch.sqrt((diff ** 2).sum(-1) + eye)
    pe = -0.5 * torch.sum((m[:, None] * m[None, :]) * (1 - eye) / dist)
    return float(ke + pe)


def test_simulate_three_body_short_horizon():
    tj, rj, vj, mj = j_simulate(n_points=60, t_max=0.5, rtol=1e-9,
                                atol=1e-9)
    tt, rt, vt, mt = t_simulate(n_points=60, t_max=0.5, rtol=1e-9,
                                atol=1e-9, device="cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert np.abs(rt.numpy() - np.asarray(rj)).max() <= 1e-6
    assert np.abs(vt.numpy() - np.asarray(vj)).max() <= 1e-6
    e0, e_end = _energy(rt[0], vt[0], mt), _energy(rt[-1], vt[-1], mt)
    assert abs(e_end - e0) < 1e-3 * abs(e0), (e0, e_end)


def test_simulate_three_body_benchmark_truth():
    """The benchmark's ground truth (2 × 128 points over [0, 2] at rtol
    1e-8): the port within the reference's own distance from an f64
    solve."""
    tj, rj, _, _ = j_simulate(n_points=256, t_max=2.0, rtol=1e-8,
                              atol=1e-8)
    tt, rt, vt, mt = t_simulate(n_points=256, t_max=2.0, rtol=1e-8,
                                atol=1e-8, device="cpu")
    np.testing.assert_array_equal(tt.numpy(), np.asarray(tj))
    s0 = {"r": rt[0].double(), "v": vt[0].double()}
    ys, _ = odeint(t_rhs, s0, tt.double(), (mt.double(),), solver="dopri5",
                   rtol=1e-12, atol=1e-12, max_steps=8192)
    truth = ys["r"].numpy()
    ref_err = np.abs(np.asarray(rj, np.float64) - truth).max()
    assert np.abs(rt.numpy() - np.asarray(rj)).max() <= ref_err
    assert np.abs(rt.numpy() - truth).max() <= 2 * ref_err
