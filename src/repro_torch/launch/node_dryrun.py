"""Mesh-sharded NODE solve dry run: run, count, roofline verdict.

The counterpart of ``repro/launch/node_dryrun.py``. A NODE cell cannot be
costed from its shapes alone: its hot loop is a data-dependent trial loop
(``core/integrate.py``), whose trip count only a run can tell. So the
cell runs once for real, the sharded ``odeint(..., batch_axis=0,
mesh=shard_mesh(...))`` train or serve solve on the ranks of the process
group (NCCL on the card, gloo with ``device="cpu"``), under
``op_cost.OpCost``, which counts this rank's work. Eager execution runs
every trial, so the counted FLOPs and bytes are the whole solve's with no
scaling by trips; the straggler's trips (the most trials any row of any
shard took) come from the gathered ``SolveStats``. The three-term
roofline (``launch/roofline.py``, the H100's constants) must not be
collective-bound: the one collective a train step adds is the shared
args' cotangent all-reduce, once a call::

    PYTHONPATH=src python -m repro_torch.launch.node_dryrun \\
        --kind train --grad-method adjoint [--batch 64] [--dim 32] \\
        [--device cpu] [--use-pallas]

Without a process group (and without torchrun's environment) the module
starts a one-rank group of its own. Each cell writes
``results/dryrun_torch/node/<cell>.json`` (rank 0) with the measured trip
counts and solve time, the counted costs (``hlo_static``: the
reference's key names, though nothing here is static or HLO), the
roofline terms and the verdict.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.launch.op_cost import OpCost
from repro_torch.launch.roofline import from_cost

RESULTS_DIR = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..",
    "results", "dryrun_torch", "node"))


def _field(t, z, w):
    """Benchmark NODE vector field: stiffness ladder + dense coupling.

    ``z[:-1]`` is the state, ``z[-1]`` a per-element log-stiffness
    (frozen: derivative 0) so a batch is stiffness-heterogeneous; ``w``
    is the shared (replicated) parameter whose cotangent is the one
    cross-rank all-reduce. Per eval: one (d-1)×(d-1) matmul ≈ 2(d-1)²
    FLOPs per element."""
    x, logk = z[:-1], z[-1]
    dx = -torch.exp(logk) * x + 0.5 * torch.tanh(x @ w)
    return torch.cat([dx, torch.zeros((1,), dtype=z.dtype, device=z.device)])


def node_problem(batch: int, dim: int, seed: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(z0 (batch, dim), ts (2,), w (dim-1, dim-1)) as f32 numpy arrays
    drawn from ``seed``; dim includes the stiffness slot, so the live
    state is dim-1 wide. (The reference draws from ``jax.random``; feed
    both packages these arrays to compare them.)"""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((dim - 1, dim - 1))
         * (0.3 / (dim - 1) ** 0.5)).astype(np.float32)
    x0 = (rng.standard_normal((batch, dim - 1)) * 0.5).astype(np.float32)
    frac = np.arange(batch) / max(batch - 1.0, 1.0)
    logk = (0.5 + 3.0 * frac ** 2).astype(np.float32)
    z0 = np.concatenate([x0, logk[:, None]], axis=1)
    ts = np.array([0.0, 1.0], np.float32)
    return z0, ts, w


def field_flops_per_eval(batch: int, dim: int) -> float:
    """Analytic FLOPs of one batched field eval (matmul + elementwise)."""
    d = dim - 1
    return float(batch) * (2.0 * d * d + 6.0 * d)


def build_node_cell(kind: str, *, batch: int, dim: int, mesh,
                    grad_method: str = "aca", rtol: float = 1e-4,
                    atol: float = 1e-4, max_steps: int = 512,
                    use_pallas: bool = False, problem=None, device="cuda"
                    ) -> Tuple[Callable, Tuple[Any, Any, Any]]:
    """The sharded NODE cell: ``train`` = the loss's value and its
    gradients w.r.t. (z0, w); ``serve`` = the forward solve only.
    ``problem`` (numpy ``(z0, ts, w)``) defaults to ``node_problem``.

    Returns ``(fn, (z0, ts, w))`` on ``device``: ``fn(z0, w)`` gives
    ``(value, (g_z0, g_w), stats)`` (train) or ``(ys, stats)`` (serve)."""
    from repro_torch.core import odeint

    z0, ts, w = (torch.as_tensor(a, device=device) for a in (
        problem if problem is not None else node_problem(batch, dim)))
    kw: Dict[str, Any] = dict(grad_method=grad_method, rtol=rtol, atol=atol,
                              max_steps=max_steps, batch_axis=0, mesh=mesh,
                              use_pallas=use_pallas)
    if grad_method != "mali":
        kw["solver"] = "dopri5"

    def solve(z0, w):
        return odeint(_field, z0, ts, (w,), **kw)

    if kind == "serve":
        def serve(z0, w):
            with torch.no_grad():
                return solve(z0, w)
        return serve, (z0, ts, w)

    def train(z0, w):
        z, ww = z0.detach().requires_grad_(), w.detach().requires_grad_()
        ys, stats = solve(z, ww)
        val = torch.sum(ys ** 2)
        grads = torch.autograd.grad(val, (z, ww))
        return val.detach(), grads, stats
    return train, (z0, ts, w)


def _process_group(device_type: str) -> None:
    """Start a group when none runs: from torchrun's environment when it
    is set, else one rank of our own on a free local port."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import free_port, init_distributed

    if dist.is_initialized():
        return
    if "RANK" in os.environ:
        init_distributed(device_type)
        return
    if device_type == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl" if device_type == "cuda" else "gloo",
        init_method=f"tcp://127.0.0.1:{free_port()}", rank=0, world_size=1)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_node_cell(kind: str = "train", *, batch: int = 64, dim: int = 32,
                  grad_method: str = "aca", n_devices: Optional[int] = None,
                  rtol: float = 1e-4, atol: float = 1e-4,
                  max_steps: int = 512, save: bool = True, device="cuda",
                  use_pallas: bool = False, problem=None) -> Dict:
    """Run, count and roofline one sharded NODE cell on the process
    group's ranks (``n_devices``, when given, must be the group's size).

    The counted run is the measurement; a second, uncounted run gives the
    solve's wall time (``measured.solve_ms``, host clock around a device
    sync). The collective term is the counted collectives' bytes, once a
    call (the shared-args all-reduce sits after the backward, the ys and
    stats gathers after the forward)."""
    import torch.distributed as dist

    from repro_torch.core.integrate import SolveStatus
    from repro_torch.distributed.sharding import shard_mesh

    dev = torch.device(device)
    _process_group(dev.type)
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(
            f"run_node_cell: n_devices={n_devices}, but the process group "
            f"has {n} ranks")
    if batch % n:
        raise ValueError(f"run_node_cell: batch {batch} does not split over "
                         f"{n} ranks")
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    mesh = shard_mesh(dev.type)
    fn, (z0, ts, w) = build_node_cell(
        kind, batch=batch, dim=dim, mesh=mesh, grad_method=grad_method,
        rtol=rtol, atol=atol, max_steps=max_steps, use_pallas=use_pallas,
        problem=problem, device=dev)

    with OpCost() as cost:
        out = fn(z0, w)
    _sync(dev)
    t0 = time.perf_counter()
    fn(z0, w)
    _sync(dev)
    solve_ms = 1e3 * (time.perf_counter() - t0)

    stats = out[-1]
    trials = stats.n_trials.cpu().numpy()
    nfe = stats.nfe.cpu().numpy()
    status = stats.status.cpu().numpy()
    per_shard = trials.reshape(n, batch // n)
    # the straggler shard's wall time is its own worst row's trials
    trips = int(per_shard.max(axis=1).max())

    # analytic model FLOPs: measured field evals × per-eval cost; a
    # backward re-evaluates f (a vjp ≈ 2× an eval): ×3 for train
    evals = float(nfe.sum()) / batch
    mult = 3.0 if kind == "train" else 1.0
    model_fl = field_flops_per_eval(batch, dim) * evals * mult

    r = from_cost(cost, n, model_fl)

    report = {
        "cell": f"node_{kind}__{grad_method}__b{batch}d{dim}x{n}",
        "kind": kind,
        "grad_method": grad_method,
        "batch": batch,
        "dim": dim,
        "n_devices": n,
        "device": dev.type,
        "use_pallas": use_pallas,
        "measured": {
            "while_trips_straggler": trips,
            "trials_per_element_min": int(trials.min()),
            "trials_per_element_max": int(trials.max()),
            "nfe_total": int(nfe.sum()),
            "all_ok": bool((status == int(SolveStatus.OK)).all()),
            "solve_ms": solve_ms,
        },
        "hlo_static": {
            "flops_body_once": cost.flops_body_once,
            "bytes_body_once": cost.bytes_body_once,
            "dynamic_whiles": cost.dynamic_whiles,
        },
        "flops_by_dtype": dict(cost.flops_by_dtype),
        "kernels": {k: dict(v) for k, v in cost.kernels.items()},
        "coll_count": dict(cost.coll_count),
        "roofline": r.to_dict(),
        "bound_time": r.bound_time,
        "compute_bound": r.dominant == "compute",
        "collective_bound": r.dominant == "collective",
    }
    if save and dist.get_rank() == 0:
        os.makedirs(RESULTS_DIR, exist_ok=True)
        path = os.path.join(RESULTS_DIR, report["cell"] + ".json")
        with open(path, "w") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
        report["path"] = path
    return report


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kind", default="train", choices=["train", "serve"])
    ap.add_argument("--grad-method", default="aca",
                    choices=["aca", "adjoint", "naive", "mali"])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--dim", type=int, default=32)
    ap.add_argument("--devices", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--use-pallas", action="store_true",
                    help="the fused solver path (K3/K4)")
    args = ap.parse_args(argv)

    rep = run_node_cell(args.kind, batch=args.batch, dim=args.dim,
                        grad_method=args.grad_method,
                        n_devices=args.devices, device=args.device,
                        use_pallas=args.use_pallas)
    rl = rep["roofline"]
    print(f"# {rep['cell']}: trips={rep['measured']['while_trips_straggler']}"
          f" flops/dev={rl['flops_per_device']:.3e}"
          f" bytes/dev={rl['bytes_per_device']:.3e}"
          f" coll/dev={rl['coll_bytes_per_device']:.3e}"
          f" dominant={rl['dominant']}"
          f" solve={rep['measured']['solve_ms']:.1f}ms"
          f" bound={rep['bound_time'] * 1e3:.4f}ms")
    print(f"# wrote {rep.get('path')}")
    if rep["collective_bound"]:
        raise SystemExit(
            "node dry-run FAILED: the sharded solve is collective-bound "
            f"(t_coll={rl['t_collective']:.3e}s > t_comp="
            f"{rl['t_compute']:.3e}s) — the batch shards are too small "
            "for the args all-reduce they amortize")
    print("# verdict: solve is "
          + ("compute" if rep["compute_bound"] else "memory")
          + "-bound, not collective-bound")


if __name__ == "__main__":
    main()
