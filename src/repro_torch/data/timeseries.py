"""Irregularly sampled time series (the Mujoco stand-in, paper Sec. 4.3).

Port of ``repro/data/timeseries.py``: trajectories of a latent linear ODE
with a nonlinear readout, observed at per-sample irregular times. The
numpy draws and the Taylor matrix exponential are the reference's, so a
seed gives the reference's bits.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import resolve_device


def irregular_series_batch(batch: int, n_obs: int, obs_dim: int = 8,
                           latent_dim: int = 4, t_max: float = 5.0,
                           seed: int = 0, device="cuda"
                           ) -> Dict[str, torch.Tensor]:
    """Returns {ts (B, T) sorted, ys (B, T, D), mask (B, T)}, f32 on
    ``device``; every row starts at t = 0.

    Latent dynamics: dz/dt = A z with A skew-symmetric + damping
    (oscillatory, well-conditioned); readout y = tanh(z W) + noise.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    skew = rng.normal(size=(latent_dim, latent_dim))
    a_mat = 0.8 * (skew - skew.T) - 0.15 * np.eye(latent_dim)
    w_out = rng.normal(size=(latent_dim, obs_dim)) / np.sqrt(latent_dim)

    ts = np.sort(rng.uniform(0, t_max, size=(batch, n_obs)), axis=1)
    ts[:, 0] = 0.0
    z0 = rng.normal(size=(batch, latent_dim))

    # exact solution via matrix exponential per observation time
    ys = np.zeros((batch, n_obs, obs_dim))
    for i in range(batch):
        for j in range(n_obs):
            m = _expm(a_mat * ts[i, j])
            z = m @ z0[i]
            ys[i, j] = np.tanh(z @ w_out)
    ys += rng.normal(scale=0.02, size=ys.shape)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    return {"ts": f32(ts), "ys": f32(ys),
            "mask": torch.ones((batch, n_obs), dtype=torch.float32,
                               device=dev)}


def merged_time_grid(ts, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Union eval grid over a batch of per-sample irregular time rows.

    ``ts`` (B, T), rows sorted ascending. Returns ``{"t_union": (M,),
    "idx": (B, T)}`` on ``ts``'s device (the CPU for an array), with
    ``t_union`` the strictly increasing union of every observation time
    (duplicates removed: ``odeint`` rejects repeated eval times) in
    ``dtype`` and ``t_union[idx[b, j]] == ts[b, j]`` (int64). ``dtype`` is
    the reference's default float: f32, or f64 where the caller asks.

    The times are cast to ``dtype`` before deduplicating, so times whose
    gap is below its resolution collapse into one knot here rather than
    into a repeat after a later cast. One batched dense-output solve,
    ``odeint(f, z0, grid["t_union"], ..., batch_axis=0,
    interpolate_ts=True)``, reads the whole batch through it; sample b's
    outputs are then ``ys[idx[b], b]``.
    """
    dev = ts.device if isinstance(ts, torch.Tensor) else torch.device("cpu")
    tdt = np.float64 if dtype == torch.float64 else np.float32
    if isinstance(ts, torch.Tensor):
        ts = ts.detach().cpu().numpy()
    tsn = np.asarray(ts, tdt)
    t_union, inv = np.unique(tsn.reshape(-1), return_inverse=True)
    return {"t_union": torch.from_numpy(t_union).to(dev),
            "idx": torch.from_numpy(
                inv.reshape(tsn.shape).astype(np.int64)).to(dev)}


def _expm(a: np.ndarray) -> np.ndarray:
    """Scaling-and-squaring Padé-free matrix exponential (Taylor, scaled).

    20-term Taylor after scaling by 2^k so that ||A/2^k|| < 0.5, accurate
    to ~1e-12 for these sizes (the reference's own, kept here: the port
    imports nothing of the reference).
    """
    norm = np.linalg.norm(a, ord=np.inf)
    k = max(0, int(np.ceil(np.log2(max(norm, 1e-30) / 0.5))))
    a_s = a / (2 ** k)
    m = np.eye(a.shape[0])
    term = np.eye(a.shape[0])
    for i in range(1, 21):
        term = term @ a_s / i
        m = m + term
    for _ in range(k):
        m = m @ m
    return m
