"""MALI's memory against the step budget — the O(1)-state claim, on the
port.

    PYTHONPATH=src python -m repro_torch.benchmarks.mali_memory \\
        [--full] [--device cuda|cpu]

Port of ``benchmarks/bench_mali_memory.py``, with its field (tanh(z W1)
W2 − 0.1 z over a (4, 128) state, N(0, 1) × 0.4 weights), its tolerance
(1e-4, 8 trials a step), its budgets N = max_steps (32 and 256 quick, 32
to 512 full), its row names and its gates. ACA keeps every accepted state
(O(N · dim)); MALI keeps none, only the scalar grid (t, h, out_idx: 3
scalars a step) and the terminal pair, since its backward inverts the
steps from the end.

The reference counts the bytes of the compiled value-and-grad's HLO; the
port has none. Its count is the bytes of every distinct storage autograd
saves for the backward (saved-tensor hooks over every op and Function:
ACA's checkpoint buffer, MALI's grid and pair) plus the parameters and
the initial state, which the backward holds too and the reference's HLO
count includes. It follows the buffers' capacity (max_steps), not the
steps taken. On a card, ``torch.cuda.max_memory_allocated`` above the
inputs is reported beside it. Gates (``common.GateFailed``): MALI's bytes grow at most
1.05× from the smallest to the largest budget, and ACA's grow more than
MALI's + 0.10.
"""

from __future__ import annotations

import argparse
from typing import Dict

import torch

from repro_torch.core import odeint
from repro_torch.device import resolve_device

from .common import emit_json, gate, record, saved_bytes, settings

D = 128
B = 4
MALI_FLATNESS_GATE = 1.05   # mali's growth from the smallest budget
SETTINGS = {True: dict(horizons=(32, 256)),
            False: dict(horizons=(32, 128, 256, 512))}


def _f(t, z, w1, w2):
    return torch.tanh(z @ w1) @ w2 - 0.1 * z


def _inputs(device):
    """(w1, w2, z0): N(0, 1) × 0.4 weights (128, 128) and a (4, 128) state
    from CPU generators seeded 0, 1, 2."""
    def randn(shape, seed):
        return torch.randn(shape, generator=torch.Generator().manual_seed(
            seed)).to(device)

    return randn((D, D), 0) * 0.4, randn((D, D), 1) * 0.4, randn((B, D), 2)


def _loss(w1, w2, z0, max_steps: int, grad_method: str):
    ys, stats = odeint(_f, z0, torch.tensor([0.0, 1.0], device=z0.device),
                       (w1, w2),
                       solver=None if grad_method == "mali" else "dopri5",
                       grad_method=grad_method, rtol=1e-4, atol=1e-4,
                       max_steps=max_steps, max_trials=8)
    return (ys[-1] ** 2).mean(), stats


def residual_bytes(max_steps: int, grad_method: str,
                   device="cuda") -> Dict:
    """The bytes of one value-and-grad at this budget: saved by autograd
    plus the inputs' (``saved``), and on a card the peak above the
    inputs."""
    dev = resolve_device(device)
    w1, w2, z0 = (x.requires_grad_() for x in _inputs(dev))
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    inputs = (w1, w2, z0)
    nbytes, (loss, stats) = saved_bytes(
        lambda: _loss(w1, w2, z0, max_steps, grad_method), inputs)
    torch.autograd.grad(loss, inputs)
    nbytes += sum(x.numel() * x.element_size() for x in inputs)
    out = {"saved": nbytes, "n_steps": int(stats.n_steps)}
    if cuda:
        torch.cuda.synchronize(dev)
        out["peak"] = torch.cuda.max_memory_allocated(dev) - base
    return out


def run(quick: bool = False, device="cuda", **cuts) -> Dict[str, float]:
    """Emit the rows and apply the gates; returns {row name: bytes}."""
    horizons = list(settings(SETTINGS, quick, cuts)["horizons"])
    lo, hi = horizons[0], horizons[-1]
    by: Dict = {}
    out: Dict[str, float] = {}
    for method in ("mali", "aca"):
        for steps in horizons:
            r = residual_bytes(steps, method, device)
            by[(method, steps)] = r["saved"]
            record(out, f"mali_memory_bytes/{method}_{steps}", r["saved"],
                   "d", "bytes autograd saves for value_and_grad + the "
                   f"inputs (n_steps {r['n_steps']})")
            if "peak" in r:
                record(out, f"mali_memory_peak_bytes/{method}_{steps}",
                       r["peak"], "d", "torch.cuda.max_memory_allocated "
                       "above the inputs")
    mali_growth = by[("mali", hi)] / max(by[("mali", lo)], 1)
    aca_growth = by[("aca", hi)] / max(by[("aca", lo)], 1)
    gate(mali_growth <= MALI_FLATNESS_GATE,
         f"mali's saved bytes grew {mali_growth:.3f}x from N={lo} to N={hi} "
         f"(gate {MALI_FLATNESS_GATE}x): the O(1)-state claim regressed", by)
    gate(aca_growth > mali_growth + 0.10,
         "ACA's full buffer did not grow past mali's: the measurement lost "
         "its contrast", by)
    emit_json("mali_memory", {
        "steps_lo": lo, "steps_hi": hi,
        "bytes_mali_lo": by[("mali", lo)], "bytes_mali_hi": by[("mali", hi)],
        "bytes_aca_lo": by[("aca", lo)], "bytes_aca_hi": by[("aca", hi)],
        "growth_mali": round(mali_growth, 4),
        "growth_aca": round(aca_growth, 4),
        "mali_vs_aca_at_hi": round(by[("mali", hi)]
                                   / max(by[("aca", hi)], 1), 4)})
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    run(quick=not a.full, device=a.device)
