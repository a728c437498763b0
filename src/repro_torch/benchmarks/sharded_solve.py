"""Mesh-sharded batched solving: rank scaling of ``odeint(mesh=...)``.

    PYTHONPATH=src python -m repro_torch.benchmarks.sharded_solve \\
        [--quick] [--device cuda|cpu] [--ranks 1,2,4,8] [--iters N]

Port of ``benchmarks/bench_sharded_solve.py``, with its problem, gates and
headline keys. The per-sample batched engine runs its batch in lockstep
in time: every trial advances all B controllers, so the whole batch pays
the straggler's trial count. Sharding the batch over ranks gives every
shard its own trial count; with a heavy-tailed stiffness batch (most rows
easy, one very stiff) the work drops from B x max_b (trials) to the sum
over shards of B_s x max_{b in s}(trials).

Protocol: the same B = 64 Dopri5/ACA solve (state d = 256, rtol = atol =
1e-7, ``max_steps=1024``; stiffness ``logk = 0.5 + 6.6 frac^5``, the top
row ~40x the median's trials) timed on n ranks for n in the ladder (1, 2,
4, 8), one host thread a rank, each rung spawned fresh, the per-row trial
counts read back from ``SolveStats``. Gates: per-element trial counts
identical on every rung (the sharded solve is the unsharded solve), and
8-rank throughput >= 3x the 1-rank rung. The inputs come from
``numpy.random.default_rng(seed)``.

``device`` picks the ranks: ``"cpu"`` runs gloo ranks on the CPU (the
reference's forced host devices); ``"cuda"`` runs NCCL ranks, one a card,
so its default ladder stops at the card count and a rung above it is
refused. Every row and the headline name the device.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .common import emit, emit_json, gate

DEVICE_LADDER = (1, 2, 4, 8)
B = 64
DIM = 256
MIN_SPEEDUP_8 = 3.0
KW = dict(solver="dopri5", rtol=1e-7, atol=1e-7, max_steps=1024,
          grad_method="aca", batch_axis=0)


def inputs(seed: int = 0):
    """(w (DIM, DIM), z0 (B, DIM)) as numpy f32: w and x0 standard normal
    draws (w scaled by 0.3/sqrt(DIM), x0 by 0.5), logk = 0.5 + 6.6
    frac^5 in the last column."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((DIM, DIM)) * (0.3 / DIM ** 0.5)
    x0 = rng.standard_normal((B, DIM - 1)) * 0.5
    frac = np.arange(B) / (B - 1.0)
    logk = 0.5 + 6.6 * frac ** 5
    z0 = np.concatenate([x0, logk[:, None]], axis=1)
    return w.astype(np.float32), z0.astype(np.float32)


def field(t, z, w):
    x, logk = z[:-1], z[-1]
    dx = -torch.exp(logk) * x + 0.5 * torch.tanh(x @ w[:-1, :-1])
    return torch.cat([dx, torch.zeros(1, dtype=z.dtype, device=z.device)])


def _rung(rank: int, n: int, iters: int, seed: int, port: int, out: str,
          device: str) -> None:
    """One rung on ``n`` ranks of ``device``: the sharded solve once
    untimed, then ``iters`` times between barriers; rank 0 writes a JSON
    line."""
    import torch.distributed as dist

    from repro_torch.core import odeint
    from repro_torch.distributed import shard_mesh

    torch.set_num_threads(1)
    on_card = device == "cuda"
    if on_card:
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if on_card else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=n)

    def settle():
        if on_card:
            torch.cuda.synchronize()
        dist.barrier()

    try:
        mesh = shard_mesh(device)
        dev = torch.device("cuda", rank) if on_card else torch.device("cpu")
        w, z0 = (torch.from_numpy(a).to(dev) for a in inputs(seed))
        ts = torch.tensor([0.0, 1.0], device=dev)
        with torch.no_grad():
            ys, st = odeint(field, z0, ts, (w,), mesh=mesh, **KW)
            settle()
            t0 = time.perf_counter()
            for _ in range(iters):
                odeint(field, z0, ts, (w,), mesh=mesh, **KW)
            settle()
            dt = (time.perf_counter() - t0) / iters
        if rank == 0:
            trials = st.n_trials.cpu().numpy()
            per_rank = trials.reshape(n, -1).max(axis=1)
            with open(out, "w") as fh:
                json.dump({"n_ranks": n, "t_s": dt, "throughput_el_s": B / dt,
                           "trials": trials.tolist(),
                           "rank_straggler_trials": per_rank.tolist(),
                           "ys_sum": float(ys.sum())}, fh)
    finally:
        dist.destroy_process_group()


def run_rung(n: int, iters: int, seed: int = 0, device: str = "cpu") -> Dict:
    """Spawn ``n`` fresh ranks of ``device`` for one rung; returns rank
    0's record."""
    import torch.multiprocessing as mp

    from repro_torch.launch.mesh import free_port

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rung.json")
        mp.spawn(_rung, args=(n, iters, seed, free_port(), out, device),
                 nprocs=n)
        with open(out) as fh:
            return json.load(fh)


def ladder_for(device: str, ranks: Sequence[int] = None) -> Tuple[int, ...]:
    """The rungs to run: ``ranks`` (default (1, 2, 4, 8)) on gloo CPU
    ranks; on the cards, the default ladder up to the card count, and a
    ``ValueError`` naming the count for a rung above it."""
    if device == "cpu":
        return tuple(DEVICE_LADDER if ranks is None else ranks)
    if device != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu'; got {device!r}")
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError(
            "sharded_solve on device 'cuda' needs a card, and torch sees "
            "none; pass device='cpu' for gloo ranks on the CPU")
    if ranks is None:
        return tuple(k for k in DEVICE_LADDER if k <= cards)
    above = [k for k in ranks if k > cards]
    if above:
        raise ValueError(
            f"rungs {above} need as many cards, and this machine has "
            f"{cards}: NCCL takes one rank a card (device='cpu' runs gloo "
            "ranks on the CPU)")
    return tuple(ranks)


def run(quick: bool = False, device: str = "cuda",
        ranks: Sequence[int] = None, iters: int = None,
        seed: int = 0) -> Dict:
    """Emit the sharded_solve rows of ``device`` over the rank ladder
    (``ladder_for``); returns the rungs' records by rank count. The
    speedup gate applies when the ladder holds 1 and 8."""
    ladder = ladder_for(device, ranks)
    n_iter = iters if iters is not None else (3 if quick else 10)
    kind = (torch.cuda.get_device_name(0) if device == "cuda"
            else "cpu gloo ranks")
    pre = f"sharded_solve/{device}"
    emit(f"{pre}/ladder", "-".join(map(str, ladder)), kind if device == "cpu"
         else f"{kind}; {torch.cuda.device_count()} card(s)")
    rungs = {}
    for n in ladder:
        rungs[n] = r = run_rung(n, n_iter, seed, device)
        straggler = max(r["rank_straggler_trials"])
        emit(f"{pre}/t_ms/{n}dev", f"{r['t_s'] * 1e3:.1f}", kind)
        emit(f"{pre}/throughput_el_s/{n}dev", f"{r['throughput_el_s']:.1f}",
             kind)
        emit(f"{pre}/straggler_trials/{n}dev", f"{straggler}", kind)
        # the lockstep trial's cost at this rung's B/n rows a rank
        emit(f"{pre}/ms_per_trial/{n}dev",
             f"{r['t_s'] * 1e3 / straggler:.3f}", kind)

    base = rungs[ladder[0]]
    # the sharded solve must be the unsharded solve: identical per-row
    # trial counts on every rung
    for n, r in rungs.items():
        gate(r["trials"] == base["trials"],
             f"per-element trial counts changed under sharding at "
             f"{n} ranks of {device}", r["trials"], base["trials"])
    speedups = {n: base["t_s"] / rungs[n]["t_s"] for n in ladder}
    for n in ladder[1:]:
        emit(f"{pre}/speedup/{n}dev", f"{speedups[n]:.2f}", kind)
        emit(f"{pre}/scaling_eff/{n}dev", f"{speedups[n] / n:.2f}", kind)
    trials = base["trials"]
    headline = {"device": device, "kind": kind, "batch": B, "dim": DIM,
                f"t_ms_{ladder[0]}dev": base["t_s"] * 1e3,
                "straggler_trials": max(trials)}
    for n in ladder[1:]:
        headline[f"speedup_{n}dev"] = speedups[n]
    s8 = None
    if 1 in rungs and 8 in rungs:
        s8 = rungs[1]["t_s"] / rungs[8]["t_s"]
        emit(f"{pre}/speedup_8dev_ge_3x", f"{int(s8 >= MIN_SPEEDUP_8)}",
             f"{kind}; measured {s8:.2f}x")
        headline.update({
            "t_ms_8dev": rungs[8]["t_s"] * 1e3,
            "scaling_eff_8dev": s8 / 8.0,
            "throughput_el_s_8dev": rungs[8]["throughput_el_s"],
            "median_shard_trials_8dev": sorted(
                rungs[8]["rank_straggler_trials"])[4],
            "gate_speedup_8dev_ge_3x": int(s8 >= MIN_SPEEDUP_8)})
    emit_json("sharded_solve", headline)
    if s8 is not None:
        gate(s8 >= MIN_SPEEDUP_8, f"sharded solve speedup at 8 ranks of "
             f"{device} is {s8:.2f}x < {MIN_SPEEDUP_8}x: lockstep waste is "
             "not being eliminated")
    return rungs


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda: NCCL ranks, one a card; cpu: gloo ranks")
    ap.add_argument("--ranks", default=None,
                    help="comma-separated rank ladder (default 1,2,4,8; "
                    "on the cards, up to their count)")
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    run(quick=a.quick, device=a.device, ranks=None if a.ranks is None else
        tuple(int(x) for x in a.ranks.split(",")), iters=a.iters,
        seed=a.seed)
