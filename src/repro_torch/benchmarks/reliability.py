"""Paper Table 3 — test-retest reliability under random re-initialization,
on the port.

    PYTHONPATH=src python -m repro_torch.benchmarks.reliability \\
        [--full] [--device cuda|cpu]

Port of ``benchmarks/bench_reliability.py``, with its row names: N runs
of the classification model from independent seeds (1000 + s), then

  * ICC(1) over the per-example correctness matrix (one-way random,
    single rater) — the paper's ICC1;
  * the mean pairwise prediction agreement (a model-free reliability
    proxy).
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from repro_torch.data import spiral_classification

from .classification import fit, forward, init_params
from .common import record, settings

SETTINGS = {True: dict(n_runs=4, steps=100, n_train=400),
            False: dict(n_runs=8, steps=300, n_train=1200)}


def icc1(mat: np.ndarray) -> float:
    """One-way random single-rater ICC over (targets, raters)."""
    n, k = mat.shape
    grand = mat.mean()
    row_means = mat.mean(axis=1)
    msb = k * ((row_means - grand) ** 2).sum() / max(n - 1, 1)
    msw = ((mat - row_means[:, None]) ** 2).sum() / max(n * (k - 1), 1)
    denom = msb + (k - 1) * msw
    return float((msb - msw) / denom) if denom > 0 else 0.0


def pairwise_agreement(preds) -> float:
    """Mean over run pairs of the share of equal predictions."""
    n = len(preds)
    return float(np.mean([(preds[i] == preds[j]).mean()
                          for i in range(n) for j in range(i + 1, n)]))


def run(quick: bool = False, device="cuda", **cuts) -> Dict[str, float]:
    """Emit the Table 3 rows; returns {row name: value}."""
    s = settings(SETTINGS, quick, cuts)
    x, y = spiral_classification(s["n_train"], seed=0, device=device)
    xt, yt = spiral_classification(300, seed=7, device=device)
    yt_np = yt.cpu().numpy()
    out: Dict[str, float] = {}
    for mode in ("node", "discrete"):
        preds, accs = [], []
        for r in range(s["n_runs"]):
            p0 = init_params(torch.Generator().manual_seed(1000 + r),
                             device=x.device)
            p, _ = fit(p0, s["steps"], x, y, mode)
            with torch.no_grad():
                lg = forward(p, xt, mode=mode, grad_method="aca")
            pr = torch.argmax(lg, -1).cpu().numpy()
            preds.append(pr)
            accs.append(float((pr == yt_np).mean()))
        correct = np.stack([(q == yt_np).astype(float) for q in preds],
                           axis=1)                     # (targets, raters)
        record(out, f"table3_icc1/{mode}", icc1(correct), ".4f",
               f"{s['n_runs']} runs, acc {np.mean(accs):.3f}"
               f"±{np.std(accs):.3f}")
        record(out, f"table3_pairwise_agreement/{mode}",
               pairwise_agreement(preds), ".4f",
               "mean pairwise prediction agreement")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    run(quick=not a.full, device=a.device)
