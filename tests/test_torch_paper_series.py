"""The port's time-series (Table 4) and three-body (Table 5) benchmarks
against the reference's at tiny settings, on the CPU.

The reference's parameters reach the port through
``convert.tree_from_jax``; data are the reference's arrays.

* Time series: the latent ODE's MSE (each sample's own irregular times:
  ``jax.vmap`` of a solo ``odeint`` on the reference side, one
  ``odeint(..., batch_axis=0)`` over (B, T) times on the port's) within
  1e-6, and the gradient of every parameter, per method. Dopri5 at
  1e-4 follows rounding in its grids, so the bound comes from the
  reference's own spread, its vmap against a loop over the samples on
  the same inputs (CPU): 1.0e-5 of each parameter's max |gradient| for
  aca and naive, 2.2e-4 for the adjoint (its reverse solve of ḡ at 1e-4);
  the bounds are about twice that: 2e-5 and 5e-4. The GRU-only baseline:
  loss and gradients 1e-5.
* Three body, over [0, 0.48] yr on the reference's ground truth, Dopri5
  at 1e-5: the mass fit's loss at log m = (0.1, -0.1, 0.05) and its
  gradient, per method, and the augmented-input NODE's at the
  reference's initial weights (aca and naive; the reference's adjoint
  through the NODE compiles for a minute), each within 1e-5 (CPU runs
  agree to 1.2e-6 and 3e-7); the LSTM baseline's unroll and gradient
  at the reference's initial weights within 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import bench_threebody as jtb
from benchmarks import bench_timeseries as jts
from repro.data import irregular_series_batch as jseries
from repro.data.threebody import simulate_three_body as jsimulate
from repro.data.threebody import three_body_rhs as jrhs
from repro_torch.benchmarks import threebody, timeseries
from repro_torch.convert import tree_from_jax

TS_BOUND = {"aca": 2e-5, "naive": 2e-5, "adjoint": 5e-4}
TB_RTOL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _port_params(pj):
    pt = tree_from_jax(jax.tree.map(np.asarray, pj), "cpu")
    return {k: v.requires_grad_() for k, v in pt.items()}


@functools.lru_cache(maxsize=None)
def _series():
    return jseries(batch=3, n_obs=6, obs_dim=timeseries.OBS, seed=0)


def _port_series():
    return {k: torch.tensor(np.asarray(v)) for k, v in _series().items()}


@pytest.mark.parametrize("gm", ["aca", "adjoint", "naive"])
def test_timeseries_mse_and_gradients(gm):
    d = _series()
    pj = jts.init_params(jax.random.PRNGKey(0))

    def mse(p):
        def one(ts, ys):
            z0 = jts.gru_encode(p, ts, ys)
            return ((jts.decode(p, z0, ts, gm) - ys) ** 2).mean()
        return jax.vmap(one)(d["ts"], d["ys"]).mean()

    lj, gj = jax.value_and_grad(mse)(pj)
    pt = _port_params(pj)
    lt = timeseries.mse(pt, _port_series(), gm)
    gt = torch.autograd.grad(lt, list(pt.values()))
    assert abs(float(lt.detach()) - float(lj)) <= 1e-6 * float(lj)
    for k, g in zip(pt, gt):
        assert _rel(g.numpy(), gj[k]) <= TS_BOUND[gm], k


def test_timeseries_rnn_baseline():
    d = _series()
    pj = jts.init_params(jax.random.PRNGKey(0))

    def rnn_mse(p):
        def one(ts, ys):
            z0 = jts.gru_encode(p, ts, ys)
            pred = jnp.broadcast_to(z0 @ p["dec"], ys.shape)
            return ((pred - ys) ** 2).mean()
        return jax.vmap(one)(d["ts"], d["ys"]).mean()

    lj, gj = jax.value_and_grad(rnn_mse)(pj)
    pt = _port_params(pj)
    lt = timeseries.rnn_mse(pt, _port_series())
    gt = torch.autograd.grad(lt, list(pt.values()), allow_unused=True,
                             materialize_grads=True)
    assert abs(float(lt.detach()) - float(lj)) <= 1e-6 * float(lj)
    for k, g in zip(pt, gt):
        if k in ("f1", "f2"):
            assert not g.any() and not np.asarray(gj[k]).any()
        else:
            assert _rel(g.numpy(), gj[k]) <= 1e-5, k


@functools.lru_cache(maxsize=None)
def _truth():
    ts, rs, vs, _ = jsimulate(n_points=24, t_max=1.0, rtol=1e-8, atol=1e-8)
    return np.asarray(ts), np.asarray(rs), np.asarray(vs)


N_FIT = 12          # fit on the first 12 points: [0, 0.48] yr


def _ref_loss(rhs, args_of, gm):
    ts, rs, vs = _truth()
    state0 = {"r": jnp.asarray(rs[0]), "v": jnp.asarray(vs[0])}

    def loss(p):
        ys = jtb._traj(p, state0, jnp.asarray(ts[:N_FIT]), rhs, gm, args_of)
        return ((ys["r"] - rs[:N_FIT]) ** 2).mean()

    return loss


def _port_loss(rhs, gm):
    ts, rs, vs = (torch.tensor(x) for x in _truth())
    state0 = {"r": rs[0], "v": vs[0]}

    def loss(p):
        ys = threebody.traj(rhs, state0, ts[:N_FIT], (p,), gm)
        return ((ys["r"] - rs[:N_FIT]) ** 2).mean()

    return loss


@pytest.mark.parametrize("gm", ["aca", "adjoint", "naive"])
def test_threebody_mass_fit_loss_and_gradient(gm):
    log_m = np.array([0.1, -0.1, 0.05], np.float32)
    lj, gj = jax.value_and_grad(_ref_loss(
        jrhs, lambda lm: (jnp.exp(lm),), gm))(jnp.asarray(log_m))
    lm = torch.tensor(log_m, requires_grad=True)
    lt = _port_loss(threebody.mass_rhs, gm)(lm)
    gt, = torch.autograd.grad(lt, [lm])
    assert abs(float(lt.detach()) - float(lj)) <= TB_RTOL * float(lj)
    assert _rel(gt.numpy(), gj) <= TB_RTOL


@pytest.mark.parametrize("gm", ["aca", "naive"])
def test_threebody_node_loss_and_gradient(gm):
    _, rs, vs = _truth()
    feat = jtb._aug_features({"r": jnp.asarray(rs[0]),
                              "v": jnp.asarray(vs[0])})
    w = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                     (int(feat.shape[0]), 9)) * 0.01)

    def node_rhs_j(t, state, w):
        acc = (jtb._aug_features(state) @ w).reshape(3, 3)
        return {"r": state["v"], "v": acc}

    lj, gj = jax.value_and_grad(_ref_loss(node_rhs_j, lambda p: (p,), gm))(
        jnp.asarray(w))
    wt = torch.tensor(w, requires_grad=True)
    lt = _port_loss(threebody.node_rhs, gm)(wt)
    gt, = torch.autograd.grad(lt, [wt])
    t_feat = threebody.aug_features({"r": torch.tensor(rs[0]),
                                     "v": torch.tensor(vs[0])})
    assert _rel(t_feat.numpy(), feat) <= 1e-6
    assert abs(float(lt.detach()) - float(lj)) <= TB_RTOL * float(lj)
    assert _rel(gt.numpy(), gj) <= TB_RTOL


def _lstm_roll_j(p, x0, n):
    """The reference's LSTM unroll (``bench_threebody.run``'s local
    ``lstm_roll``, which the module does not export)."""
    def cell(carry, _):
        h, c, x = carry
        z = x @ p["wx"] + h @ p["wh"]
        i, f, g, o = jnp.split(z, 4)
        c2 = jax.nn.sigmoid(f + 1.0) * c + jax.nn.sigmoid(i) * jnp.tanh(g)
        h2 = jax.nn.sigmoid(o) * jnp.tanh(c2)
        x2 = x + h2 @ p["out"]
        return (h2, c2, x2), x2

    hid = threebody.LSTM_HID
    _, xs = jax.lax.scan(cell, (jnp.zeros(hid), jnp.zeros(hid), x0), None,
                         length=n)
    return xs


def test_threebody_lstm_roll_and_gradient():
    """The LSTM baseline's unroll and its loss gradient at the reference's
    initial weights, within 1e-5 (f32 ops in the same order)."""
    ks = jax.random.split(jax.random.PRNGKey(1), 3)
    hid = threebody.LSTM_HID
    pj = {"wx": jax.random.normal(ks[0], (9, 4 * hid)) * 0.2,
          "wh": jax.random.normal(ks[1], (hid, 4 * hid)) * 0.2,
          "out": jax.random.normal(ks[2], (hid, 9)) * 0.2}
    _, rs, _ = _truth()
    flat = rs.reshape(len(rs), 9)

    def loss_j(p):
        return ((_lstm_roll_j(p, flat[0], 11) - flat[1:12]) ** 2).mean()

    lj, gj = jax.value_and_grad(loss_j)(pj)
    pt = _port_params(pj)
    tflat = torch.tensor(flat)
    xs = threebody.lstm_roll(pt, tflat[0], 11)
    assert _rel(xs.detach().numpy(), _lstm_roll_j(pj, flat[0], 11)) <= 1e-5
    lt = ((xs - tflat[1:12]) ** 2).mean()
    gt = torch.autograd.grad(lt, list(pt.values()))
    assert abs(float(lt.detach()) - float(lj)) <= 1e-5 * float(lj)
    for k, g in zip(pt, gt):
        assert _rel(g.numpy(), gj[k]) <= 1e-5, k
