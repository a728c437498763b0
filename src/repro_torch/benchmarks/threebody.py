"""Paper Table 5 / Fig. 8 — the three-body problem, on the port.

    PYTHONPATH=src python -m repro_torch.benchmarks.threebody \\
        [--full] [--device cuda|cpu]

Port of ``benchmarks/bench_threebody.py``, with its row names. Ground
truth: the port's Dopri5 at rtol=1e-8 on Newton's equations (Eq. 32)
with unequal masses. Models:

  * ODE — f is Eq. 32 itself, only the 3 masses are unknown (full
    physical knowledge), fit by gradient descent through the solver with
    each gradient method from equal unit masses (``log_m = 0``);
  * NODE — f = FC(augmented input) (partial knowledge, Eq. 33/34);
  * LSTM — a sequence model on the raw coordinates (no knowledge), its
    unroll a Python loop in place of ``lax.scan``.

Train on t ∈ [0, 1], report the trajectory MSE on t ∈ [0, 2]
(extrapolation). Random weights come from seeded CPU generators.
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from repro_torch.core import odeint
from repro_torch.data.threebody import simulate_three_body, three_body_rhs
from repro_torch.device import resolve_device

from .common import fit, record, settings

SETTINGS = {True: dict(n_pts=64, fit_steps=60, node_methods=("aca",)),
            False: dict(n_pts=128, fit_steps=200,
                        node_methods=("aca", "adjoint", "naive"))}
LSTM_HID = 64


def traj(rhs, state0, ts, args, grad_method: str):
    ys, _ = odeint(rhs, state0, ts, args, solver="dopri5",
                   grad_method=grad_method, rtol=1e-5, atol=1e-5,
                   max_steps=512)
    return ys


# the ordered pairs (i, j), i != j, in the reference's loop order
_PAIR_I = (0, 0, 1, 1, 2, 2)
_PAIR_J = (1, 2, 0, 2, 0, 1)


def aug_features(state) -> torch.Tensor:
    """Eq. 33: positions, velocities and, for each ordered pair (i, j),
    d = r_i - r_j at powers 1..3 of 1/|d| (90 features, the reference's
    order), all six pairs at once."""
    r, v = state["r"], state["v"]          # (3, 3)
    d = r[_PAIR_I, :] - r[_PAIR_J, :]      # (6, 3)
    n = torch.sqrt((d ** 2).sum(-1, keepdim=True) + 1e-8)
    pairs = torch.stack([d, d / n, d / n ** 2, d / n ** 3], dim=1)
    return torch.cat([r.reshape(-1), v.reshape(-1), pairs.reshape(-1)])


def node_rhs(t, state, w):
    acc = (aug_features(state) @ w).reshape(3, 3)
    return {"r": state["v"], "v": acc}


def mass_rhs(t, state, log_m):
    return three_body_rhs(t, state, torch.exp(log_m))


def lstm_init(generator: torch.Generator, device) -> Dict[str, torch.Tensor]:
    shapes = {"wx": (9, 4 * LSTM_HID), "wh": (LSTM_HID, 4 * LSTM_HID),
              "out": (LSTM_HID, 9)}
    return {k: (torch.randn(s, generator=generator) * 0.2).to(device)
            .requires_grad_() for k, s in shapes.items()}


def lstm_roll(p, x0, n: int) -> torch.Tensor:
    """n residual next-step predictions from x0 (9,): (n, 9)."""
    h = x0.new_zeros(LSTM_HID)
    c = x0.new_zeros(LSTM_HID)
    x = x0
    xs = []
    for _ in range(n):
        z = x @ p["wx"] + h @ p["wh"]
        i, f, g, o = torch.split(z, LSTM_HID)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        x = x + h @ p["out"]              # residual next-step prediction
        xs.append(x)
    return torch.stack(xs)


def ground_truth(n_pts: int, device):
    """(ts_all, rs, vs, m_true) over [0, 2] yr at 2 × ``n_pts`` points."""
    return simulate_three_body(n_points=2 * n_pts, t_max=2.0,
                               masses=(1.0, 0.8, 1.2), rtol=1e-8, atol=1e-8,
                               device=device)


def mass_fit(gm: str, fit_steps: int, ts_all, rs, vs, n_half: int):
    """(log_m after the fit, MSE over [0, 2]) of the ODE row for ``gm``."""
    state0 = {"r": rs[0], "v": vs[0]}
    log_m = torch.zeros(3, device=rs.device, requires_grad=True)
    log_m, _ = fit(log_m, fit_steps, 0.05, lambda lm: (
        (traj(mass_rhs, state0, ts_all[:n_half], (lm,), gm)["r"]
         - rs[:n_half]) ** 2).mean())
    with torch.no_grad():
        ys = traj(mass_rhs, state0, ts_all, (log_m,), "aca")
        return log_m.detach(), float(((ys["r"] - rs) ** 2).mean())


def run(quick: bool = False, device="cuda", **cuts) -> Dict[str, float]:
    """Emit the Table 5 rows; returns {row name: MSE}."""
    s = settings(SETTINGS, quick, cuts)
    dev = resolve_device(device)
    n_half, fit_steps = s["n_pts"], s["fit_steps"]
    ts_all, rs, vs, m_true = ground_truth(n_half, dev)
    state0 = {"r": rs[0], "v": vs[0]}
    out: Dict[str, float] = {}

    # ODE (mass fitting)
    for gm in ("aca", "adjoint", "naive"):
        log_m, mse = mass_fit(gm, fit_steps, ts_all, rs, vs, n_half)
        record(out, f"table5_ode_mse/{gm}", mse, ".6f",
               f"[0,2]yr; fitted m="
               f"{np.round(np.exp(log_m.cpu().numpy()), 3)}"
               f" true={m_true.cpu().numpy()}")

    # NODE (augmented input)
    feat_dim = int(aug_features(state0).shape[0])
    w0 = torch.randn((feat_dim, 9),
                     generator=torch.Generator().manual_seed(0)) * 0.01
    for gm in s["node_methods"]:
        w = w0.to(dev).requires_grad_()
        w, _ = fit(w, fit_steps, 3e-3, lambda p: (
            (traj(node_rhs, state0, ts_all[:n_half], (p,), gm)["r"]
             - rs[:n_half]) ** 2).mean())
        with torch.no_grad():
            ys = traj(node_rhs, state0, ts_all, (w,), "aca")
            mse = float(((ys["r"] - rs) ** 2).mean())
        record(out, f"table5_node_mse/{gm}", mse, ".6f",
               "aug-input FC dynamics")

    # LSTM (no knowledge)
    flat = rs.reshape(len(ts_all), 9)
    p = lstm_init(torch.Generator().manual_seed(1), dev)
    p, _ = fit(p, 3 * fit_steps, 3e-3, lambda q: (
        (lstm_roll(q, flat[0], n_half - 1) - flat[1:n_half]) ** 2).mean())
    with torch.no_grad():
        pred = lstm_roll(p, flat[0], len(ts_all) - 1)
        record(out, "table5_lstm_mse", float(((pred - flat[1:]) ** 2).mean()),
               ".6f", "no physical knowledge")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    run(quick=not a.full, device=a.device)
