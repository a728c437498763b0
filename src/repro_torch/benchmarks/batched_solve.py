"""Per-sample batched solving (``batch_axis``) against its alternatives, on
the port.

    PYTHONPATH=src python -m repro_torch.benchmarks.batched_solve \\
        [--quick] [--device cuda|cpu] [--seed N]

Port of ``benchmarks/bench_batched_solve.py``, with its problem, rows and
assertion. A stiffness-heterogeneous batch, dx = −e^{logk} x + 0.1
tanh(w x) with a frozen logk per sample spanning linspace(0, 3, B),
goes through the adaptive solver (Dopri5, rtol = atol = 1e-5,
``max_steps=128``, ACA gradients) three ways:

  * ``per_sample`` — ``batch_axis=0``: one masked trial loop, one
    controller per element.
  * ``vmap_solo``  — B solo solves in a loop. The reference vmaps the
    solo solver; ``torch.func.vmap`` cannot carry the trial loop's host
    reads, and the loop gives the same per-element grids, which is what
    the reference's row stands for.
  * ``lockstep``   — the batch as ONE (B, d) state under a single
    controller: one error norm, one shared grid for every element.

Rows per strategy: forward and gradient (of sum z(1)² with respect to w)
wall seconds, total evaluations of f in sample-evals (a lockstep
evaluation touches all B samples) and the accepted-step spread. Gates:
the per-sample step counts are not all equal (else the batch
degenerated), and ``per_sample``'s per-element steps equal
``vmap_solo``'s. The inputs come from ``numpy.random.default_rng(seed)``.
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch
from torch.func import vmap

from repro_torch.core import odeint
from repro_torch.device import resolve_device

from .common import emit, emit_json, gate, record, timed

KW = dict(solver="dopri5", rtol=1e-5, atol=1e-5, max_steps=128,
          grad_method="aca")


def field(t, z, w):
    x, logk = z[:-1], z[-1]
    dx = -torch.exp(logk) * x + 0.1 * torch.tanh(w @ x)
    return torch.cat([dx, torch.zeros(1, dtype=z.dtype, device=z.device)])


def inputs(B: int, d: int, seed: int = 0):
    """(w (d-1, d-1), z0 (B, d)) as numpy f32: x0 and w standard normal
    draws (w scaled by 0.3), logk = linspace(0, 3, B) in the last
    column."""
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((B, d - 1))
    w = rng.standard_normal((d - 1, d - 1)) * 0.3
    logk = np.linspace(0.0, 3.0, B)
    z0 = np.concatenate([x0, logk[:, None]], axis=1)
    return w.astype(np.float32), z0.astype(np.float32)


def solve_per_sample(w, z0, ts):
    return odeint(field, z0, ts, (w,), batch_axis=0, **KW)


def solve_vmap_solo(w, z0, ts):
    """B solo solves: ys (T, B, d) and per-element (B,) stats."""
    outs = [odeint(field, z, ts, (w,), **KW) for z in z0.unbind(0)]
    ys = torch.stack([y for y, _ in outs], dim=1)
    stats = type(outs[0][1])(*(torch.stack(s) for s in
                               zip(*(st for _, st in outs))))
    return ys, stats


def solve_lockstep(w, z0, ts):
    def fb(t, zb, w):
        return vmap(lambda z: field(t, z, w))(zb)

    return odeint(fb, z0, ts, (w,), **KW)


STRATEGIES = (("per_sample", solve_per_sample),
              ("vmap_solo", solve_vmap_solo),
              ("lockstep", solve_lockstep))


def run(quick: bool = False, device="cuda", seed: int = 0) -> Dict:
    """Emit the batched_solve rows; returns {row: value} plus each
    strategy's per-element ``n_steps`` under ``n_steps``."""
    dev = resolve_device(device)
    B, d = (8, 16) if quick else (32, 64)
    reps = 2 if quick else 5
    ts = torch.tensor([0.0, 1.0], device=dev)
    w_np, z0_np = inputs(B, d, seed)
    w, z0 = torch.from_numpy(w_np).to(dev), torch.from_numpy(z0_np).to(dev)

    out: Dict = {"n_steps": {}}
    headline = {"batch": B, "dim": d}
    for name, solve in STRATEGIES:
        def fwd():
            with torch.no_grad():
                return solve(w, z0, ts)[0]

        def grad():
            wg = w.clone().requires_grad_()
            ys, _ = solve(wg, z0, ts)
            loss = torch.sum(ys[-1] ** 2)
            return loss.detach(), torch.autograd.grad(loss, wg)[0]

        with torch.no_grad():
            _, stats = solve(w, z0, ts)
        n_steps = stats.n_steps.reshape(-1).tolist()
        nfe = stats.nfe.reshape(-1).tolist()
        # lockstep: one recorded evaluation touches all B samples
        sample_evals = sum(nfe) if len(nfe) == B else sum(nfe) * B
        t_fwd = timed(fwd, n=reps, device=dev)
        t_grad = timed(grad, n=reps, device=dev)

        record(out, f"batched_solve_fwd_s/{name}", t_fwd, ".4f")
        record(out, f"batched_solve_grad_s/{name}", t_grad, ".4f")
        record(out, f"batched_solve_sample_evals/{name}", sample_evals, "d")
        emit(f"batched_solve_steps_min_max/{name}", f"{min(n_steps)}",
             f"{max(n_steps)}")
        out["n_steps"][name] = n_steps
        headline[f"{name}_fwd_s"] = round(t_fwd, 4)
        headline[f"{name}_grad_s"] = round(t_grad, 4)
        headline[f"{name}_sample_evals"] = sample_evals

    spread = out["n_steps"]["per_sample"]
    headline["per_sample_step_spread"] = f"{min(spread)}..{max(spread)}"
    emit_json("batched_solve", headline)
    # per-element grids must differ (else the heterogeneous batch
    # degenerated and the comparison is meaningless), and the per-sample
    # loop must take each element's solo grid
    gate(len(set(spread)) > 1, "per-sample step counts all equal", spread)
    gate(spread == out["n_steps"]["vmap_solo"], "per_sample's per-element "
         "steps differ from vmap_solo's", spread, out["n_steps"]["vmap_solo"])
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    run(quick=a.quick, device=a.device, seed=a.seed)
