"""The three-body gravitational system (paper Sec. 4.4).

Port of ``repro/data/threebody.py``. State {"r": (3, 3), "v": (3, 3)};
dynamics Eq. 32:

    r̈_i = -Σ_{j≠i} G m_j (r_i - r_j) / |r_i - r_j|³

``simulate_three_body`` makes the ground truth with the port's own Dopri5
at a tight tolerance (unequal masses, arbitrary initial conditions). At
rtol 1e-8 in f32 the error estimate sits at the field's rounding, so the
accepted grid follows rounding noise: compare trajectories, not grids.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core import odeint
from repro_torch.device import resolve_device

G_CONST = 1.0  # normalized units (AU / yr / solar-mass style)


def three_body_rhs(t, state, masses):
    """state {"r": (3, 3), "v": (3, 3)}; masses (3,)."""
    r, v = state["r"], state["v"]
    diff = r[:, None, :] - r[None, :, :]                   # r_i - r_j
    dist3 = torch.sum(diff ** 2, -1) ** 1.5
    eye = torch.eye(3, dtype=torch.bool, device=r.device)
    dist3 = torch.where(eye, torch.ones_like(dist3), dist3)  # mask self
    acc = -G_CONST * torch.sum(
        torch.where(eye[..., None], torch.zeros_like(diff),
                    masses[None, :, None] * diff / dist3[..., None]),
        dim=1)
    return {"r": v, "v": acc}


def simulate_three_body(
    n_points: int = 1000,
    t_max: float = 2.0,
    masses: Tuple[float, float, float] = (1.0, 0.8, 1.2),
    seed: int = 0,
    rtol: float = 1e-8,
    atol: float = 1e-8,
    device="cuda",
):
    """Returns (ts (T,), rs (T, 3, 3), vs (T, 3, 3), masses (3,)), f32 on
    ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    # well-separated initial positions, mild random velocities
    r0 = np.array([[1.0, 0.1, -0.2], [-0.9, -0.4, 0.3], [0.1, 0.8, 0.1]])
    r0 += rng.normal(scale=0.05, size=r0.shape)
    v0 = rng.normal(scale=0.3, size=(3, 3))
    v0 -= v0.mean(0, keepdims=True)      # zero total momentum

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    m = f32(masses)
    state0 = {"r": f32(r0), "v": f32(v0)}
    ts = _linspace(t_max, n_points, dev)
    ys, _ = odeint(three_body_rhs, state0, ts, (m,), solver="dopri5",
                   grad_method="aca", rtol=rtol, atol=atol, max_steps=4096)
    return ts, ys["r"], ys["v"], m


def _linspace(t_max: float, n: int, device) -> torch.Tensor:
    """f32 ``jnp.linspace(0, t_max, n)`` as the reference computes it on the
    CPU (XLA folds ``iota / (n - 1) * t_max`` into ``iota · (t_max · (1 /
    (n - 1)))``), then the endpoint; ``torch.linspace`` rounds otherwise."""
    f32 = dict(dtype=torch.float32, device=device)
    stop = torch.tensor(t_max, **f32)
    if n < 2:
        return stop.new_zeros(n)
    step = stop * (torch.ones((), **f32) / torch.tensor(n - 1, **f32))
    return torch.cat([torch.arange(n - 1, **f32) * step, stop.reshape(1)])
