"""Checkpoint memory against the horizon — the segmented-ACA memory
claim, on the port.

    PYTHONPATH=src python -m repro_torch.benchmarks.memory \\
        [--full] [--device cuda|cpu]

Port of ``benchmarks/bench_memory.py``, with its row names. ACA's full
trajectory checkpoint keeps every accepted state, O(N_f · dim);
``checkpoint_segments=K`` keeps K snapshots (and their k0 carries) and
allocates one seg_len-slot replay buffer in the backward, O((K + N_f /
K) · dim), for about one more ψ per accepted step.

The reference reads its bytes from the compiled HLO; the port has none.
Its count is the bytes autograd saves for the backward (every storage the
saved-tensor hooks see, the inputs left out: the checkpoint's state
buffer or snapshots, the k0 snapshots and the scalar grids) plus the
replay buffer the segmented sweep allocates (seg_len × one state). Like
the reference's, it follows the buffers' capacity (max_steps), not the
steps taken. On a card, ``torch.cuda.max_memory_allocated`` above the
inputs is reported beside it (``memory_peak_bytes/...``). Two sweeps,
with the reference's gates (``common.GateFailed`` when one fails):

  * K = 1, 4, ⌈√max_steps⌉ at a horizon the full buffer still holds: the
    bytes shrink as K grows and end below the full buffer's;
  * the horizon: the full buffer grows like max_steps, ``"auto"`` like
    its square root.
"""

from __future__ import annotations

import argparse
from typing import Dict

import torch

from repro_torch.core import odeint
from repro_torch.core.integrate import resolve_segmentation
from repro_torch.device import resolve_device

from .common import emit_json, gate, record, saved_bytes

D = 32
B = 8


def _f(t, z, w1, w2):
    return torch.tanh(z @ w1) @ w2 - 0.1 * z


def _inputs(device):
    """(w1, w2, z0): N(0, 1) × 0.4 weights (32, 32) and a (8, 32) state
    from CPU generators seeded 0, 1, 2."""
    def randn(shape, seed):
        return torch.randn(shape, generator=torch.Generator().manual_seed(
            seed)).to(device)

    return randn((D, D), 0) * 0.4, randn((D, D), 1) * 0.4, randn((B, D), 2)


def _loss(w1, w2, z0, max_steps: int, segments):
    ys, stats = odeint(_f, z0, torch.tensor([0.0, 1.0], device=z0.device),
                       (w1, w2), solver="dopri5", grad_method="aca",
                       rtol=1e-5, atol=1e-5, max_steps=max_steps,
                       max_trials=8, checkpoint_segments=segments)
    return (ys[-1] ** 2).mean(), stats


def residual_bytes(max_steps: int, segments, device="cuda") -> Dict:
    """The bytes of one ACA value-and-grad at this capacity: saved by
    autograd, the replay buffer, their sum and (on a card) the peak."""
    dev = resolve_device(device)
    w1, w2, z0 = (x.requires_grad_() for x in _inputs(dev))
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    nbytes, (loss, stats) = saved_bytes(
        lambda: _loss(w1, w2, z0, max_steps, segments), (w1, w2, z0))
    torch.autograd.grad(loss, (w1, w2, z0))
    _, seg_len = resolve_segmentation(segments, max_steps)
    out = {"saved": nbytes,
           "replay": 0 if seg_len is None else seg_len * z0.numel()
           * z0.element_size(),
           "n_steps": int(stats.n_steps)}
    out["total"] = out["saved"] + out["replay"]
    if cuda:
        torch.cuda.synchronize(dev)
        out["peak"] = torch.cuda.max_memory_allocated(dev) - base
    return out


def run(quick: bool = False, device="cuda") -> Dict[str, float]:
    """Emit the memory rows; returns {row name: bytes}."""
    base_steps = 192 if quick else 512
    horizons = [64, base_steps] if quick else [64, 192, base_steps]
    sqrt_k = int(-(-base_steps ** 0.5 // 1))
    out: Dict[str, float] = {}

    def emit_one(name, r, derived):
        record(out, name, r["total"], "d", derived + f"; saved "
               f"{r['saved']} + replay {r['replay']}")
        if "peak" in r:
            record(out, name.replace("_bytes", "_peak_bytes", 1),
                   r["peak"], "d", "torch.cuda.max_memory_allocated above "
                   "the inputs")

    # --- K sweep at a horizon the full buffer can still hold ----------
    k_values = [1, 4, sqrt_k]
    by_k = {}
    for k in [None] + k_values:
        label = "full" if k is None else f"k{k}"
        by_k[label] = residual_bytes(base_steps, k, device)
        emit_one(f"memory_residual_bytes/{label}", by_k[label],
                 f"bytes saved for the backward + replay buffer, "
                 f"max_steps={base_steps}")
    # the gate: state memory shrinks as K grows toward the sqrt(N)
    # optimum of the O(K + N/K) cost model, and ends below the full buffer
    seq = [by_k[f"k{k}"]["total"] for k in k_values]
    gate(seq == sorted(seq, reverse=True)
         and seq[-1] < by_k["full"]["total"],
         "segmented checkpointing did not shrink the bytes",
         {k: v["total"] for k, v in by_k.items()})

    # --- horizon sweep: full vs auto ----------------------------------
    growth = {}
    for steps in horizons:
        if steps == base_steps:
            full_b, auto_b = by_k["full"], by_k[f"k{sqrt_k}"]
        else:
            full_b = residual_bytes(steps, None, device)
            auto_b = residual_bytes(steps, "auto", device)
        growth[steps] = (full_b["total"], auto_b["total"])
        emit_one(f"memory_horizon_bytes/full_{steps}", full_b,
                 "full buffer: O(N) state slots")
        emit_one(f"memory_horizon_bytes/auto_{steps}", auto_b,
                 "checkpoint_segments='auto': O(sqrt N) state slots")

    lo, hi = horizons[0], horizons[-1]
    emit_json("memory", {
        "max_steps": base_steps,
        "bytes_full": by_k["full"]["total"],
        "bytes_k1": by_k["k1"]["total"],
        f"bytes_k{sqrt_k}_sqrt": by_k[f"k{sqrt_k}"]["total"],
        "sqrt_vs_full_ratio": round(by_k[f"k{sqrt_k}"]["total"]
                                    / by_k["full"]["total"], 4),
        "horizon_growth_full": round(growth[hi][0]
                                     / max(growth[lo][0], 1), 2),
        "horizon_growth_auto": round(growth[hi][1]
                                     / max(growth[lo][1], 1), 2),
    })
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    run(quick=not a.full, device=a.device)
