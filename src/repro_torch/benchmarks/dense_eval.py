"""Dense eval grids: ``interpolate_ts`` natural-grid solving against
forced step landings, on the port.

    PYTHONPATH=src python -m repro_torch.benchmarks.dense_eval \\
        [--device cuda|cpu]

Port of ``benchmarks/bench_dense_eval.py``, with its row names and gates.
A 64-point eval grid on van der Pol (μ = 4, the paper's reverse-error
testbed) forces the landing engine onto every eval time, cutting its
steps to about 1/64 of the horizon whatever the error control wants;
with ``interpolate_ts=True`` the controller keeps its natural steps and
the eval times are read off each accepted step's 4th-order interpolant.

Gates (the reference's; ``common.GateFailed`` when one does not hold):
  * at least 1.5× fewer ψ trials at 64 eval points;
  * at most 2e-4 interpolation error against a 10⁴× tighter solve;
  * a reverse-time round trip (descending ts on the natural grid) back
    to z0 within 1e-2.
"""

from __future__ import annotations

import argparse
from typing import Dict

import torch

from repro_torch.core import odeint
from repro_torch.device import resolve_device

from .common import emit_json, gate, record

MU = 4.0
T1 = 3.0
N_EVAL = 64
TOL = 1e-5


def _vdp(t, z, mu):
    return torch.stack([z[1], mu * (1 - z[0] ** 2) * z[1] - z[0]])


def run(quick: bool = False, device="cuda") -> Dict[str, float]:
    """Emit the dense_eval rows (one size: ``quick`` is accepted for the
    runner and changes nothing, as in the reference); returns {row:
    value}."""
    dev = resolve_device(device)
    z0 = torch.tensor([2.0, 0.0], device=dev)
    mu = torch.tensor(MU, device=dev)
    ts = torch.linspace(0.0, T1, N_EVAL, device=dev)
    kw = dict(solver="dopri5", grad_method="aca", rtol=TOL, atol=TOL,
              max_steps=4096, max_trials=20)
    out: Dict[str, float] = {}
    with torch.no_grad():
        ys_land, st_land = odeint(_vdp, z0, ts, (mu,), **kw)
        ys_int, st_int = odeint(_vdp, z0, ts, (mu,), interpolate_ts=True,
                                **kw)
        ys_ref, _ = odeint(_vdp, z0, ts, (mu,), solver="dopri5",
                           grad_method="aca", rtol=1e-9, atol=1e-9,
                           max_steps=8192, max_trials=20)
    err_land = float((ys_land - ys_ref).abs().max())
    err_int = float((ys_int - ys_ref).abs().max())
    trials_land, trials_int = int(st_land.n_trials), int(st_int.n_trials)
    speedup = trials_land / max(trials_int, 1)

    record(out, "dense_eval_trials/landing", trials_land, "d",
           f"dopri5 aca tol={TOL}, {N_EVAL} forced landings")
    record(out, "dense_eval_trials/interpolate_ts", trials_int, "d",
           "natural grid + per-step interpolant reads")
    record(out, "dense_eval_trials/ratio", speedup, ".2f",
           "landing / interpolated trials")
    record(out, "dense_eval_err/landing", err_land, ".3e",
           "max |y - ref(1e-9)|")
    record(out, "dense_eval_err/interpolate_ts", err_int, ".3e",
           "max |y - ref(1e-9)| incl. interpolation")
    gate(speedup >= 1.5, "interpolate_ts must cut >= 1.5x trials on the "
         "dense grid", trials_land, trials_int)
    gate(err_int <= 2e-4, "interpolation error above the 2e-4 gate",
         err_int)

    # reverse time on the natural grid: a short window (the van der Pol
    # limit cycle attracts forward, so long reverse solves are
    # ill-posed, the paper's Fig. 4 point)
    t_rev0 = T1 / 8
    with torch.no_grad():
        ys_fwd, _ = odeint(_vdp, z0, torch.linspace(0.0, t_rev0, 8,
                                                    device=dev), (mu,), **kw)
        ys_rev, st_rev = odeint(_vdp, ys_fwd[-1],
                                torch.linspace(t_rev0, 0.0, 8, device=dev),
                                (mu,), interpolate_ts=True, **kw)
    rev_gap = float((ys_rev[-1] - z0).abs().max())
    record(out, "dense_eval_reverse/trials", int(st_rev.n_trials), "d",
           "descending-ts natural-grid solve back to t0")
    record(out, "dense_eval_reverse/roundtrip_gap", rev_gap, ".3e",
           "|z(0) roundtrip - z0| (forward + reverse solve error)")
    gate(rev_gap < 1e-2, "reverse-time roundtrip drifted", rev_gap)

    emit_json("dense_eval", {
        "n_eval": N_EVAL, "tol": TOL, "trials_landing": trials_land,
        "trials_interpolated": trials_int,
        "trial_ratio": round(speedup, 3), "max_err_landing": err_land,
        "max_err_interpolated": err_int,
        "reverse_roundtrip_gap": rev_gap})
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    run(device=ap.parse_args().device)
