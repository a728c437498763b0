"""Paper Table 2 / Fig. 7 — classification: NODE (per gradient method)
against the discrete residual net with the same parameters, on the port.

    PYTHONPATH=src python -m repro_torch.benchmarks.classification \\
        [--full] [--device cuda|cpu]

Port of ``benchmarks/bench_classification.py``, with its row names. The
CIFAR stand-in is 3-arm spiral classification lifted to 16 features
(``repro_torch.data.spiral_classification``). Model: z' = f(z) with f =
tanh(z W1) W2 per block (2 blocks, width 64), a linear head; the
discrete baseline replaces each ODE block by z + f(z). The reference
jit-compiles its training step; here a step is eager autograd and the
ported AdamW (constant 3e-3).
"""

from __future__ import annotations

import argparse
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import odeint_final
from repro_torch.data import spiral_classification
from . import common
from .common import record, settings

DIM, HID, CLASSES, BLOCKS = 16, 64, 3, 2
ADAPTIVE = ("heun_euler", "bosh3", "dopri5")
SETTINGS = {True: dict(n_train=400, n_test=300, steps=100),
            False: dict(n_train=1500, n_test=600, steps=400)}


def init_params(generator: torch.Generator, device="cuda"
                ) -> Dict[str, torch.Tensor]:
    """N(0, 1) × 0.3 weights drawn from ``generator`` (a CPU generator:
    a card's draws differ) in the reference's key order, then moved to
    ``device`` as leaves that take a gradient."""
    shapes = {}
    for i in range(BLOCKS):
        shapes[f"w1_{i}"] = (DIM, HID)
        shapes[f"w2_{i}"] = (HID, DIM)
    shapes["head"] = (DIM, CLASSES)
    return {k: (torch.randn(s, generator=generator) * 0.3).to(device)
            .requires_grad_() for k, s in shapes.items()}


def _f(t, z, w1, w2):
    return torch.tanh(z @ w1) @ w2


def forward(p, x, mode: str, grad_method: str = "aca",
            solver: str = "heun_euler", rtol: float = 1e-2,
            steps: int = 4) -> torch.Tensor:
    """Logits of the NODE (``mode="node"``: each block an ``odeint_final``
    over [0, 1]) or of the discrete residual net."""
    z = x
    for i in range(BLOCKS):
        w1, w2 = p[f"w1_{i}"], p[f"w2_{i}"]
        if mode == "node":
            kw = dict(rtol=rtol, atol=rtol, max_steps=32) \
                if solver in ADAPTIVE else dict(steps_per_interval=steps)
            z, _ = odeint_final(_f, z, 0.0, 1.0, (w1, w2), solver=solver,
                                grad_method=grad_method, **kw)
        else:                      # discrete residual block (ResNet)
            z = z + _f(0.0, z, w1, w2)
    return z @ p["head"]


@torch.no_grad()
def accuracy(p, x, y, **kw) -> float:
    logits = forward(p, x, **kw)
    return float((torch.argmax(logits, -1) == y).float().mean())


def loss_fn(p, x, y, mode: str, grad_method: str = "aca",
            solver: str = "heun_euler") -> torch.Tensor:
    """Mean cross-entropy of the logits."""
    lg = forward(p, x, mode=mode, grad_method=grad_method, solver=solver)
    return -torch.gather(F.log_softmax(lg, -1), 1, y[:, None]).mean()


def fit(p, steps: int, x, y, mode: str, grad_method: str = "aca",
        solver: str = "heun_euler") -> Tuple[Dict[str, torch.Tensor], float]:
    """``steps`` AdamW steps (constant 3e-3) from ``p``; returns (params,
    the last step's loss)."""
    return common.fit(p, steps, 3e-3, lambda q: loss_fn(
        q, x, y, mode, grad_method, solver))


def train(mode: str, grad_method: str, steps: int, x, y, xt, yt,
          solver: str = "heun_euler"):
    """The reference's ``train``: ``fit`` from the seed-0 weights."""
    p = init_params(torch.Generator().manual_seed(0), device=x.device)
    return fit(p, steps, x, y, mode, grad_method, solver)


def run(quick: bool = False, device="cuda", **cuts) -> Dict[str, float]:
    """Emit the Table 2 rows; returns {row name: test accuracy}."""
    s = settings(SETTINGS, quick, cuts)
    x, y = spiral_classification(s["n_train"], seed=0, device=device)
    # same lift_seed=0
    xt, yt = spiral_classification(s["n_test"], seed=7, device=device)
    out: Dict[str, float] = {}
    for mode, gm in (("node", "aca"), ("node", "adjoint"),
                     ("node", "naive"), ("discrete", "-")):
        p, loss = train(mode, gm if gm != "-" else "aca", s["steps"], x, y,
                        xt, yt)
        acc = accuracy(p, xt, yt, mode=mode,
                       grad_method="aca" if gm == "-" else gm)
        tag = f"{mode}" + (f"_{gm}" if gm != "-" else "")
        record(out, f"table2_test_acc/{tag}", acc, ".4f",
               f"spiral stand-in, {s['steps']} steps, final loss "
               f"{loss:.3f}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    run(quick=not a.full, device=a.device)
