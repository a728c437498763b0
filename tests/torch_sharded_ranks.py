"""The rank side of ``tests/test_torch_sharded_solve.py``.

    PYTHONPATH=src python tests/torch_sharded_ranks.py OUT_DIR

Spawns 8 gloo ranks on the CPU once (``torch.multiprocessing.spawn``,
one thread each). Every rank runs every sharded case of the test file
(``odeint(..., batch_axis=0, mesh=...)`` on a flat 8-rank ``("data",)``
mesh, a ``(data=4, model=2)``, a ``(pod=2, data=2, model=2)`` and a
``(data=2, model=4)`` mesh) on
the same global inputs; rank r also runs the unsharded solves of the
cases whose index is r modulo 8, and the solo solves of batch row r.
Each rank writes its results to ``OUT_DIR/rank{r}.npz`` (keys
``"<case>/<field>"``), and the test file compares them in its own
process. Imports neither JAX nor the reference.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 8
B, D = 8, 4
TS = [0.0, 0.5, 1.0]
W = 0.7
METHODS = ("aca", "adjoint", "naive", "mali")
FAULT_ROW = 5


def field(t, z, w):
    """Per-sample field with state-embedded stiffness: z[-1] holds the
    row's log-rate (derivative 0), so one batch spans easy to stiff and
    every row earns its own adaptive grid."""
    x, logk = z[:-1], z[-1]
    dx = -torch.exp(logk) * x + 0.1 * torch.tanh(w * x)
    return torch.cat([dx, torch.zeros(1, dtype=z.dtype, device=z.device)])


def hetero_batch(b=B, d=D, top=3.5, seed=0):
    x0 = np.random.default_rng(seed).standard_normal((b, d - 1)) * 0.5
    logk = np.linspace(0.0, top, b)
    return np.concatenate([x0, logk[:, None]], axis=1).astype(np.float32)


def kw(method):
    k = dict(rtol=1e-5, atol=1e-5, grad_method=method, batch_axis=0)
    k.update(dict(max_steps=2048) if method == "mali"
             else dict(solver="dopri5", max_steps=64))
    return k


def batch_for(method):
    # the ALF pair needs ~e^logk steps at this tolerance: mali gets the
    # milder ladder, as the reference's test gives it
    return hetero_batch(top=1.5 if method == "mali" else 3.5)


def mixed_batch():
    z = hetero_batch()
    return {"a": z, "b": (z[:, :2] * 0.5).astype(np.float32)}


def mixed_field(t, z, w, wb):
    return {"a": field(t, z["a"], w), "b": -wb * z["b"]}


def _stats(st, out):
    for name in st._fields:
        out[name] = getattr(st, name).numpy()


def _solve(mesh, method, *, use_pallas=False, grad=("z", "w"), f=field,
           z0=None, args_dict=False, probe=False, **extra):
    """One solve (and its backward when ``grad`` names z and/or w): ys,
    stats, gradients and the collectives counted in each pass."""
    from repro_torch.core import odeint
    from repro_torch.distributed import counts, reset_counts

    z0 = batch_for(method) if z0 is None else z0
    z = torch.tensor(z0, requires_grad="z" in grad)
    w = torch.tensor(np.float32(W), requires_grad="w" in grad)
    seen = []
    if probe:
        inner = f

        def f(t, zz, ww):
            seen.append(counts["all_gather"] + counts["all_reduce"])
            return inner(t, zz, ww)
    if args_dict:
        fd = f
        f, args = (lambda t, zz, a: fd(t, zz, a["w"])), {"w": w}
    else:
        args = (w,)
    reset_counts()
    ys, st = odeint(f, z, TS, args, mesh=mesh, use_pallas=use_pallas,
                    **{**kw(method), **extra})
    out = {"ys": ys.detach().numpy()}
    _stats(st, out)
    fwd = dict(counts)
    out["fwd_collectives"] = np.array([fwd["all_gather"],
                                       fwd["all_reduce"]])
    n_fwd_calls = len(seen)
    if grad:
        loss = torch.sum(ys) if args_dict else torch.sum(ys * ys)
        loss.backward()
        if "z" in grad:
            out["gz"] = z.grad.numpy()
        if "w" in grad:
            out["gw"] = w.grad.numpy()
        out["bwd_collectives"] = np.array(
            [counts["all_gather"] - fwd["all_gather"],
             counts["all_reduce"] - fwd["all_reduce"]])
    if probe:
        # the collective count each field evaluation saw
        out["probe_fwd"] = np.array(seen[:n_fwd_calls])
        out["probe_bwd"] = np.array(seen[n_fwd_calls:])
    return out


def _mixed(mesh, rows=slice(None)):
    """The bf16 + f32 state with an f32 and a bf16 parameter on ``rows``
    of the batch. Unsharded, it also solves each half of the batch alone
    (the rows of each shard of the (data=2, model=4) mesh): their bf16
    parameter gradients are the shards' partial sums."""
    from repro_torch.core import odeint
    from repro_torch.distributed import counts, reset_counts

    zn = mixed_batch()
    z = {"a": torch.tensor(zn["a"][rows], requires_grad=True),
         "b": torch.tensor(zn["b"][rows]).bfloat16().requires_grad_()}
    w = torch.tensor(np.float32(W), requires_grad=True)
    # a bf16 parameter beside the f32 one: both cotangents in one all_reduce
    wb = torch.tensor(W).bfloat16().requires_grad_()
    reset_counts()
    ys, st = odeint(mixed_field, z, TS, (w, wb), mesh=mesh, **kw("aca"))
    fwd = dict(counts)
    loss = torch.sum(ys["a"] ** 2) + torch.sum(ys["b"].float() ** 2)
    loss.backward()
    out = {"ys_a": ys["a"].detach().numpy(),
           "ys_b": ys["b"].detach().float().numpy(),
           "gz_a": z["a"].grad.numpy(), "gz_b": z["b"].grad.float().numpy(),
           "gw": w.grad.numpy(), "gwb": wb.grad.float().numpy(),
           "dtype_b": np.array(str(ys["b"].dtype)),
           "dtype_gwb": np.array(str(wb.grad.dtype)),
           "bwd_collectives": np.array(
               [counts["all_gather"] - fwd["all_gather"],
                counts["all_reduce"] - fwd["all_reduce"]])}
    _stats(st, out)
    if mesh is None and rows == slice(None):
        for k, half in enumerate((slice(0, B // 2), slice(B // 2, B))):
            out[f"gwb_part{k}"] = _mixed(None, half)["gwb"]
    return out


def _node(mesh):
    from repro_torch.core.node_block import NodeConfig, node_block_apply

    base = NodeConfig(enabled=True, solver="dopri5", grad_method="aca",
                      rtol=1e-4, atol=1e-4, max_steps=64, batch_axis=0)
    cfg = dataclasses.replace(base, mesh=mesh)
    zT = node_block_apply(lambda p, z, t: field(t, z, p),
                          torch.tensor(np.float32(W)),
                          torch.tensor(hetero_batch()), cfg)
    return {"zT": zT.numpy()}


def _fault(mesh):
    from torch_faults import faulty_field

    z0 = hetero_batch()
    tag = float(z0[FAULT_ROW, -1])
    fbad = faulty_field(field, "nan", t_ge=0.5,
                        predicate=lambda t, z: (z[-1] - tag).abs() < 1e-4)
    return _solve(mesh, "aca", grad=(), f=fbad, z0=z0)


def _errors(mesh_flat, mesh_model):
    """The three validation errors' messages ('' when none was raised)."""
    from repro_torch.core import odeint

    out = {}
    w = (torch.tensor(np.float32(W)),)
    cases = {
        "uneven": (mesh_flat, hetero_batch(b=6), kw("aca")),
        "no_batch_axis": (mesh_flat, hetero_batch()[0],
                          {k: v for k, v in kw("aca").items()
                           if k != "batch_axis"}),
        "no_data_axis": (mesh_model, hetero_batch(), kw("aca")),
    }
    for name, (mesh, z0, k) in cases.items():
        try:
            odeint(field, torch.tensor(z0), TS, w, mesh=mesh, **k)
            out[name] = np.array("")
        except ValueError as e:
            out[name] = np.array(str(e))
    return out


def cases(meshes):
    """name -> callable(mesh or None) for every case; ``meshes`` maps the
    case to its mesh under sharding."""
    table = {}
    for m in METHODS:
        for route, up in (("plain", False), ("kernel", True)):
            table[f"parity/{m}/{route}"] = (
                "flat", lambda mesh, m=m, up=up: _solve(
                    mesh, m, use_pallas=up, probe=(m == "aca" and not up)))
    h0 = torch.full((B,), 1e-3)
    table["h0"] = ("flat", lambda mesh: _solve(mesh, "aca", grad=(),
                                               z0=hetero_batch(), h0=h0))
    for m in METHODS:
        table[f"scalar_args/{m}"] = (
            "flat", lambda mesh, m=m: _solve(mesh, m, grad=("z",)))
        table[f"dict_args/{m}"] = (
            "flat", lambda mesh, m=m: _solve(mesh, m, grad=("z",),
                                             args_dict=True))
    table["mesh_2d"] = ("2d", lambda mesh: _solve(mesh, "aca",
                                                  z0=hetero_batch()))
    table["mesh_3d"] = ("3d", lambda mesh: _solve(mesh, "aca",
                                                  z0=hetero_batch()))
    table["segments"] = ("flat", lambda mesh: _solve(
        mesh, "aca", grad=(), z0=hetero_batch(), checkpoint_segments=4))
    table["interpolate"] = ("flat", lambda mesh: _solve(
        mesh, "aca", grad=(), z0=hetero_batch(), interpolate_ts=True))
    table["fault"] = ("flat", _fault)
    table["node"] = ("flat", _node)
    table["mixed"] = ("two", _mixed)
    # mali against the reference at 1e-4 (below it the ALF stepsize of
    # the stiffer rows follows rounding noise)
    table["mali_ref"] = ("flat", lambda mesh: _solve(mesh, "mali", rtol=1e-4,
                                                     atol=1e-4))
    return table


def worker(rank: int, world: int, port: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.core import odeint
        from repro_torch.distributed import (batch_partition_axes,
                                             batch_shard_count, shard_mesh)

        meshes = {
            "flat": shard_mesh("cpu"),
            "2d": init_device_mesh("cpu", (4, 2),
                                   mesh_dim_names=("data", "model")),
            "3d": init_device_mesh("cpu", (2, 2, 2),
                                   mesh_dim_names=("pod", "data", "model")),
            "two": init_device_mesh("cpu", (2, 4),
                                    mesh_dim_names=("data", "model")),
        }
        model_only = init_device_mesh("cpu", (world,),
                                      mesh_dim_names=("model",))
        res = {"mesh_2d_axes/axes": np.array(
                   list(batch_partition_axes(meshes["2d"]))),
               "mesh_2d_axes/count": np.array(
                   batch_shard_count(meshes["2d"]))}
        table = cases(meshes)
        for name, (mesh_key, run) in table.items():
            for k, v in run(meshes[mesh_key]).items():
                res[f"{name}/sharded/{k}"] = v
        # the unsharded solves last: with no collective among them, no
        # rank waits on another's share
        for i, (name, (_, run)) in enumerate(table.items()):
            if i % world == rank:
                for k, v in run(None).items():
                    res[f"{name}/unsharded/{k}"] = v
        for m in METHODS:
            # this rank's row solved alone (no batch axis, no mesh)
            k = {n: v for n, v in kw(m).items() if n != "batch_axis"}
            ys, st = odeint(field, torch.tensor(batch_for(m)[rank]), TS,
                            (torch.tensor(np.float32(W)),), **k)
            res[f"solo/{m}/row{rank}/ys"] = ys.numpy()
            res[f"solo/{m}/row{rank}/n_steps"] = st.n_steps.numpy()
        for k, v in _errors(meshes["flat"], model_only).items():
            res[f"errors/{k}"] = v
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **res)
    except Exception:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def main(out_dir: str) -> None:
    from repro_torch.launch.mesh import free_port

    mp.spawn(worker, args=(WORLD, free_port(), out_dir), nprocs=WORLD)


if __name__ == "__main__":
    main(sys.argv[1])
