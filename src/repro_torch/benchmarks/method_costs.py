"""Paper Table 1 — computation, memory and graph-depth profile of the
naive, adjoint and ACA methods on one NODE block, on the port.

    PYTHONPATH=src python -m repro_torch.benchmarks.method_costs \\
        [--full] [--device cuda|cpu]

Port of ``benchmarks/bench_method_costs.py``, with its row names and its
four variants: aca, adjoint, naive and ``aca_pallas`` (``use_pallas=True``:
every stage sum and error norm through kernels K1 and K2 on a card; their
plain versions on the CPU). The field is tanh(z W1) W2 over a (32, 64)
state, Dopri5 at rtol=atol=1e-5 over [0, 1]. Rows:

  * ``table1_nfe`` — field evaluations of the forward solve
    (``SolveStats.nfe``). The naive method reports the trials it takes ×
    stages, where the reference reports its whole trial budget × stages
    (a deliberate divergence, ROADMAP queue 3);
  * ``table1_grad_walltime_ms`` — median of eager value-and-grad calls on
    the device, each ending in a synchronize;
  * ``table1_accepted_steps`` — N_t;
  * ``table1_residual_bytes`` — the bytes autograd keeps for the backward,
    not the reference's HLO traffic: every distinct storage that the
    forward's saved-tensor hooks see (each op's saved tensors and each
    autograd Function's ``save_for_backward``: ACA's trajectory
    checkpoint, the adjoint's outputs, the naive method's tape), the
    parameters and the initial state left out. It is the same count on
    any device.
"""

from __future__ import annotations

import argparse
from typing import Dict, Tuple

import torch

from repro_torch.core import SolveStats, odeint
from repro_torch.device import resolve_device

from .common import (device_name, emit_json, record, saved_bytes,
                     settings, timed)

D = 64
ROWS = 32
VARIANTS = (("aca", False), ("adjoint", False), ("naive", False),
            ("aca_pallas", True))
SETTINGS = {True: dict(max_steps=32, reps=1),
            False: dict(max_steps=64, reps=3)}


def _f(t, z, w1, w2):
    return torch.tanh(z @ w1) @ w2


def init(device="cuda", rows: int = ROWS):
    """(w1, w2, z0): N(0, 1) × 0.4 weights (64, 64) and a (rows, 64)
    state, from CPU generators seeded 0, 1, 2, moved to ``device``."""
    dev = resolve_device(device)

    def randn(shape, seed):
        return torch.randn(shape, generator=torch.Generator().manual_seed(
            seed))

    return ((randn((D, D), 0) * 0.4).to(dev),
            (randn((D, D), 1) * 0.4).to(dev), randn((rows, D), 2).to(dev))


def loss_and_stats(label: str, w1, w2, z0, max_steps: int,
                   checkpoint_segments=None
                   ) -> Tuple[torch.Tensor, torch.Tensor, SolveStats]:
    """(loss, z(1), stats) of one variant: mean z(1)² of the solve.
    ``checkpoint_segments`` segments ACA's buffer (aca variants only);
    ``"mali"`` runs its ALF pair stepper in place of Dopri5."""
    ts = torch.tensor([0.0, 1.0], device=z0.device)
    kw = {} if checkpoint_segments is None else dict(
        checkpoint_segments=checkpoint_segments)
    method = label.split("_")[0]
    ys, stats = odeint(_f, z0, ts, (w1, w2),
                       solver=None if method == "mali" else "dopri5",
                       grad_method=method, rtol=1e-5,
                       atol=1e-5, max_steps=max_steps, max_trials=8,
                       use_pallas=label == "aca_pallas", **kw)
    return (ys[-1] ** 2).mean(), ys[-1], stats


def value_and_grad(label: str, w1, w2, z0, max_steps: int,
                   checkpoint_segments=None):
    """(loss, (dL/dw1, dL/dw2), z(1), stats) of one variant."""
    w1 = w1.detach().requires_grad_()
    w2 = w2.detach().requires_grad_()
    loss, z1, stats = loss_and_stats(label, w1, w2, z0, max_steps,
                                     checkpoint_segments)
    return loss, torch.autograd.grad(loss, (w1, w2)), z1.detach(), stats


def residual_bytes(label: str, w1, w2, z0, max_steps: int) -> int:
    """Bytes of the distinct storages autograd saves in the forward of one
    variant, the inputs' own left out (see the module docstring)."""
    w1 = w1.detach().requires_grad_()
    w2 = w2.detach().requires_grad_()
    nbytes, _ = saved_bytes(
        lambda: loss_and_stats(label, w1, w2, z0, max_steps), (w1, w2, z0))
    return nbytes


def run(quick: bool = False, device="cuda", **cuts) -> Dict[str, float]:
    """Emit the Table 1 rows; returns {row name: value}."""
    s = settings(SETTINGS, quick, cuts)
    w1, w2, z0 = init(device)
    where = device_name(device)
    out: Dict[str, float] = {}
    headline = {}
    for label, _ in VARIANTS:
        _, _, _, stats = value_and_grad(label, w1, w2, z0, s["max_steps"])
        nfe_note = ("forward f evals (N_f x N_t x m structure)"
                    if label != "naive" else
                    "forward f evals: the trials taken x stages (the "
                    "reference reports its whole trial budget x stages)")
        record(out, f"table1_nfe/{label}", int(stats.nfe), "d", nfe_note)
        dt = timed(value_and_grad, label, w1, w2, z0, s["max_steps"],
                   n=s["reps"], device=device)
        record(out, f"table1_grad_walltime_ms/{label}", dt * 1e3, ".1f",
               f"eager value and grad, {where}")
        record(out, f"table1_accepted_steps/{label}", int(stats.n_steps),
               "d", "N_t")
        nbytes = residual_bytes(label, w1, w2, z0, s["max_steps"])
        record(out, f"table1_residual_bytes/{label}", nbytes, "d",
               "bytes autograd saves for the backward (saved-tensor "
               "hooks over every op and Function), inputs excluded; not "
               "the reference's HLO traffic; the same on any device")
        headline[f"nfe_{label}"] = int(stats.nfe)
        headline[f"grad_walltime_ms_{label}"] = round(dt * 1e3, 1)
        headline[f"residual_bytes_{label}"] = nbytes
    emit_json("method_costs", headline)
    return out


def peak_memory(label: str, rows: int, max_steps: int = 64,
                device="cuda", checkpoint_segments=None,
                with_grads: bool = False) -> Dict[str, float]:
    """Peak device memory of one value-and-grad call of a variant (or
    ``"mali"``) at ``rows`` × 64, above the inputs (a card only): where the
    state outnumbers the 8,192 parameters. ``with_grads`` also returns the
    gradients (``grads``), to compare two buffers."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("peak_memory reads torch.cuda's allocator; it "
                         "needs a CUDA device")
    w1, w2, z0 = init(dev, rows=rows)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    _, grads, _, stats = value_and_grad(label, w1, w2, z0, max_steps,
                                        checkpoint_segments)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev) - base
    return {"peak_bytes": peak, "n_steps": int(stats.n_steps),
            "n_trials": int(stats.n_trials), "nfe": int(stats.nfe),
            "state_elements": rows * D, "parameters": 2 * D * D,
            **({"grads": grads} if with_grads else {})}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    run(quick=not a.full, device=a.device)
