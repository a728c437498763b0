"""Beyond the paper: the gradient-method comparison on a transformer LM.

Port of ``benchmarks/bench_node_lm.py``. The paper compares ACA, adjoint
and naive on CNN classifiers and MLP dynamics; here the same ablation is
one flag on a continuous-depth transformer LM (node18_cifar's SMOKE,
fixed-grid rk2, identical init and data): N steps with each method, the
final loss and the step time, then the discrete stack. Expected: ACA ≈
naive (the same discretization), the adjoint drifts. Rows keep the
reference's names.

    PYTHONPATH=src python -m repro_torch.benchmarks.run --only node_lm \\
        [--device cpu]
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.node_block import NodeConfig
from repro_torch.data import TokenPipeline
from repro_torch.models.config import RunConfig
from repro_torch.models.lm import build_model
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.optim.grad_utils import CompressionState
from repro_torch.train.loop import TrainLoopConfig, build_train_step
from repro_torch.train.state import make_train_state

from .common import record

SETTINGS = {"quick": dict(steps=25), "full": dict(steps=80)}


def _train(node: NodeConfig, steps: int, pipe: TokenPipeline,
           device) -> Tuple[List[float], float]:
    cfg = get_smoke_config("node18_cifar")
    m = build_model(cfg, RunConfig(compute_dtype=torch.float32, node=node))
    opt = adamw(cosine_warmup(3e-3, 5, steps))
    step = build_train_step(m, opt, TrainLoopConfig())
    state = make_train_state(m, opt, seed=0, device=device)
    comp = CompressionState(error=())
    losses = []
    state, comp, mt = step(state, pipe.batch(0), comp)   # untimed first
    t0 = time.monotonic()
    for s in range(1, steps):
        state, comp, mt = step(state, pipe.batch(s), comp)
        losses.append(float(mt["loss"]))
    dt = (time.monotonic() - t0) / max(steps - 1, 1)
    return losses, dt


def run(quick: bool = False, device="cuda", **cuts) -> Dict[str, float]:
    steps = cuts.get("steps", SETTINGS["quick" if quick else "full"]["steps"])
    pipe = TokenPipeline(vocab=512, seq_len=64, global_batch=8, seed=0,
                         device=str(device))
    out: Dict[str, float] = {}
    results = {}
    for gm in ("aca", "adjoint", "naive"):
        node = NodeConfig(enabled=True, regime="fixed", solver="rk2",
                          grad_method=gm, steps_per_interval=2)
        losses, dt = _train(node, steps, pipe, device)
        results[gm] = losses
        record(out, f"nodelm_final_loss/{gm}", losses[-1], ".4f",
               f"{steps} steps, {dt*1e3:.0f} ms/step")
    losses, dt = _train(NodeConfig(enabled=False), steps, pipe, device)
    record(out, "nodelm_final_loss/discrete", losses[-1], ".4f",
           f"{steps} steps, {dt*1e3:.0f} ms/step")

    # ACA and naive: the same discrete solution, so the curves track
    d_an = float(np.mean(np.abs(np.array(results["aca"])
                                - np.array(results["naive"]))))
    d_aj = float(np.mean(np.abs(np.array(results["aca"])
                                - np.array(results["adjoint"]))))
    record(out, "nodelm_curve_dist/aca_vs_naive", d_an, ".5f",
           "mean |Δloss| over training (same discretization)")
    record(out, "nodelm_curve_dist/aca_vs_adjoint", d_aj, ".5f",
           "adjoint drifts from the discretize-then-optimize pair")
    return out


if __name__ == "__main__":
    run(quick=True)
