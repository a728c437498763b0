"""Paper Tables 6/7 — robustness to the test-time solver, on the port.

    PYTHONPATH=src python -m repro_torch.benchmarks.solver_robustness \\
        [--full] [--device cuda|cpu]

Port of ``benchmarks/bench_solver_robustness.py``, with its row names.
Train the NODE classifier with HeunEuler (rtol=1e-2, the paper's
setting), then evaluate it with Euler/RK2/RK4 at several stepsizes and
the adaptive pairs WITHOUT retraining; repeat for the discrete baseline
read as a NODE. The paper's finding: the NODE degrades ~1%, the discrete
net ~7%.
"""

from __future__ import annotations

import argparse
from typing import Dict

from repro_torch.data import spiral_classification

from .classification import accuracy, train
from .common import record, settings

FIXED = (("euler", 8), ("euler", 2), ("rk2", 4), ("rk4", 2))
ADAPTIVE = ("bosh3", "dopri5")
SETTINGS = {True: dict(n_train=400, n_test=300, steps=100),
            False: dict(n_train=1500, n_test=600, steps=400)}


def run(quick: bool = False, device="cuda", **cuts) -> Dict[str, float]:
    """Emit the Table 6/7 rows; returns {row name: value}."""
    s = settings(SETTINGS, quick, cuts)
    x, y = spiral_classification(s["n_train"], seed=0, device=device)
    # same lift_seed=0
    xt, yt = spiral_classification(s["n_test"], seed=7, device=device)
    out: Dict[str, float] = {}

    # NODE trained with HeunEuler
    p_node, _ = train("node", "aca", s["steps"], x, y, xt, yt,
                      solver="heun_euler")
    base = accuracy(p_node, xt, yt, mode="node", solver="heun_euler")
    record(out, "table7_node_base_acc/heun_euler", base, ".4f",
           "train&test same solver")
    for sol, st in FIXED:
        acc = accuracy(p_node, xt, yt, mode="node", solver=sol, steps=st)
        record(out, f"table7_node_delta/{sol}_steps{st}", base - acc, "+.4f",
               "acc drop vs train solver")
    for sol in ADAPTIVE:
        acc = accuracy(p_node, xt, yt, mode="node", solver=sol)
        record(out, f"table7_node_delta/{sol}", base - acc, "+.4f",
               "acc drop vs train solver")

    # discrete net evaluated as NODE with different solvers (Table 6)
    p_disc, _ = train("discrete", "aca", s["steps"], x, y, xt, yt)
    base_d = accuracy(p_disc, xt, yt, mode="discrete")
    record(out, "table6_discrete_base_acc", base_d, ".4f", "")
    for sol, st in FIXED:
        acc = accuracy(p_disc, xt, yt, mode="node", solver=sol, steps=st)
        record(out, f"table6_discrete_delta/{sol}_steps{st}", base_d - acc,
               "+.4f", "discrete net re-read as ODE: depth sensitivity")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    run(quick=not a.full, device=a.device)
