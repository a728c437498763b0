"""Production dry run: one (arch x shape) cell on a fake mesh, counted.

The counterpart of ``repro/launch/dryrun.py``. The reference fakes 512
host devices and lowers each cell from ShapeDtypeStructs; the port builds
the production mesh as a real ``DeviceMesh`` over a "fake" process group
of 256 (``pod16x16``) or 512 (``pod2x16x16``) ranks in this one process,
places fake-tensor DTensors on it (``FakeTensorMode``: shapes, dtypes and
devices, no memory) and runs one train step (``train/loop.py::
build_train_step``), prefill or decode step under ``op_cost.OpCost``,
which counts rank 0's local work. Nothing is allocated and no device is
needed::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_72b \\
        --shape train_4k [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all \
        --shape train_4k --node | --remat none

Each cell writes ``results/dryrun_torch/<mesh>/<arch>__<shape>.json``
with the memory analysis (``argument_bytes``: the rank's local state,
batch and caches; ``output_bytes``; ``temp_bytes``: the peak of the
bytes the step allocates, outputs included; ``generated_code_bytes``:
null, there is no compiled program), ``trace_s`` and the roofline terms
(``launch/roofline.py``).

``--remat`` (default ``block``, as the reference's) sets a train cell's
``RunConfig.remat``: under ``block`` each layer group's activations are
recomputed in the backward (``torch.utils.checkpoint``), so the cell
counts one more forward of the groups and holds fewer temp bytes; other
kinds run ``none``. ``--node`` runs the stack's blocks as NODE blocks in
train cells, the reference's fixed rk2 ACA grid of ``--node-steps``
steps (default 2): each rank solves its batch block of the residual
stream (``models/transformer.py``); the report's ``node_mode`` and
``remat`` carry the settings, and a ``--node`` cell saves under
``__node`` unless ``--tag`` names it. The cells count the plain route;
``build_cell(..., use_pallas=True)`` builds the kernels' route (K7-K10
in serving, K1/K2 in NODE blocks), which the card check counts against
a real run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import ARCHS, SHAPES, get_config, shape_plan
from repro_torch.core.node_block import NodeConfig
from repro_torch.distributed.sharding import (DEFAULT_TRAIN_RULES,
                                              mesh_shape, placements_for)
from repro_torch.launch import roofline as rl
from repro_torch.launch.op_cost import OpCost
from repro_torch.models.common import map_defs
from repro_torch.models.config import RunConfig
from repro_torch.models.frontends import frontend_batch_abstract
from repro_torch.models.lm import build_model

RESULTS_DIR = os.path.normpath(os.path.join(
    os.path.dirname(__file__), "..", "..", "..",
    "results", "dryrun_torch"))



def node_config(node: bool, node_steps: int = 2) -> NodeConfig:
    """The reference's NODE cells: a fixed rk2 ACA grid of ``node_steps``
    steps a block (``NodeConfig()`` without ``node``)."""
    if not node:
        return NodeConfig()
    return NodeConfig(enabled=True, regime="fixed", grad_method="aca",
                      solver="rk2", steps_per_interval=node_steps)


def fake_mesh(shape: Tuple[int, ...], names: Tuple[str, ...],
              device_type: str = "cpu"):
    """A ``DeviceMesh`` of ``shape`` over a "fake" process group of as many
    ranks, this process rank 0 (collectives return at once, moving
    nothing). A fake group already running is replaced; any other group
    raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.distributed.sharding import device_mesh

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                "fake_mesh: a real process group is running; a dry run "
                "needs its own fake group")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    return device_mesh(device_type, shape, names)


def production_mesh(multi_pod: bool = False, device_type: str = "cpu"):
    """``launch/mesh.py``'s production layout on a fake group."""
    if multi_pod:
        return fake_mesh((2, 16, 16), ("pod", "data", "model"), device_type)
    return fake_mesh((16, 16), ("data", "model"), device_type)


def mesh_name(mesh) -> str:
    if mesh is None:
        return "none"
    shape = mesh_shape(mesh)
    if shape == {"data": 16, "model": 16}:
        return "pod16x16"
    if shape == {"pod": 2, "data": 16, "model": 16}:
        return "pod2x16x16"
    return "fake" + "x".join(str(v) for v in shape.values())


def local_shape(shape, placements, mesh) -> Tuple[int, ...]:
    """A rank's block of a tensor of ``shape`` placed evenly
    (``placements_for`` keeps only dims that divide)."""
    out = list(shape)
    for n, p in zip(mesh_shape(mesh).values(), placements):
        if p.is_shard():
            out[p.dim] //= n
    return tuple(out)


def _fake_leaf(shape, dtype, logical, rules, mesh, device):
    if mesh is None:
        return torch.empty(shape, dtype=dtype, device=device)
    from torch.distributed.tensor import DTensor

    pl = placements_for(logical, rules, mesh, shape)
    local = torch.empty(local_shape(shape, pl, mesh), dtype=dtype,
                        device=device)
    return DTensor.from_local(local, mesh, pl, run_check=False)


def fake_params(defs, rules, mesh, device):
    """A ParamDef tree as fake tensors (call under ``FakeTensorMode``),
    DTensors placed by the logical axes on ``mesh``."""
    return map_defs(lambda d: _fake_leaf(d.shape, d.dtype, d.logical,
                                         rules, mesh, device), defs)


def _batch_abstract(cfg, kind: str, seq: int, gb: int
                    ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    if cfg.frontend != "none" and kind != "decode":
        b = frontend_batch_abstract(cfg, gb, seq)
        if kind == "prefill":
            b = {"embeds": b["embeds"]}
        return b
    if kind == "train":
        return {"tokens": ((gb, seq), torch.int32),
                "labels": ((gb, seq), torch.int32),
                "mask": ((gb, seq), torch.float32)}
    if kind == "prefill":
        return {"tokens": ((gb, seq), torch.int32)}
    # decode: one new token (frontend archs feed a 1-step embedding)
    if cfg.frontend != "none":
        return {"embeds": ((gb, 1, cfg.d_model), torch.bfloat16)}
    return {"tokens": ((gb, 1), torch.int32)}


def _batch_logical(name: str):
    return ("batch", "seq", "embed_act") if name == "embeds" \
        else ("batch", "seq")


def fake_batch(abstract, rules, mesh, device):
    return {k: _fake_leaf(s, dt, _batch_logical(k), rules, mesh, device)
            for k, (s, dt) in abstract.items()}


def local_bytes(tree) -> int:
    """Bytes a rank holds of a tree of tensors and DTensors."""
    from torch.distributed.tensor import DTensor

    total = 0
    for x in pytree.tree_leaves(tree):
        if isinstance(x, DTensor):
            x = x.to_local()
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
    return total


@dataclasses.dataclass
class Cell:
    """One dry-run cell: ``fn(*args)`` runs its step on fake tensors made
    under ``fake_mode`` (enter it again to run)."""
    fn: Callable
    args: Tuple[Any, ...]
    cfg: Any
    plan: Tuple[int, int, str]
    fake_mode: Any
    remat: str = "none"


def build_cell(arch: str, shape: str, mesh, *, node: bool = False,
               rules=None, remat: str = "block", microbatches: int = 1,
               node_steps: int = 2, config=None,
               plan: Optional[Tuple[int, int, str]] = None,
               use_pallas: bool = False, device="cpu",
               max_seq: Optional[int] = None) -> Optional[Cell]:
    """The cell's step and its fake arguments, or None when the shape
    skips the arch. ``remat`` applies to train cells only and ``node``
    (with ``node_steps``, ``node_config``) to their blocks. ``config`` and
    ``plan`` (seq, global batch, kind) override the registry's (the
    tests' smoke cells), ``max_seq`` the KV capacity (default: the cell's
    sequence length)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.optim.grad_utils import CompressionState
    from repro_torch.train.loop import TrainLoopConfig, build_train_step
    from repro_torch.train.state import TrainState

    if plan is None:
        plan = shape_plan(arch, shape)
        if plan is None:
            return None
    seq, gb, kind = plan
    cfg = config if config is not None else get_config(arch)
    rules = rules or DEFAULT_TRAIN_RULES
    rcfg = RunConfig(mesh=mesh, rules=rules, compute_dtype=torch.bfloat16,
                     param_dtype=torch.float32 if kind == "train"
                     else torch.bfloat16,
                     max_seq=seq if max_seq is None else max_seq,
                     use_pallas=use_pallas,
                     remat=remat if kind == "train" else "none",
                     node=node_config(node, node_steps))
    model = build_model(cfg, rcfg)
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    dev = torch.device(device)
    with fake:
        params = fake_params(model.defs, rules, mesh, dev)
        batch = fake_batch(_batch_abstract(cfg, kind, seq, gb), rules, mesh,
                           dev)
        if kind == "train":
            opt = adamw(cosine_warmup(3e-4, 100, 10000), weight_decay=0.1)
            step = build_train_step(model, opt, TrainLoopConfig(
                microbatches=microbatches, clip_norm=1.0,
                compression="none"))
            state = TrainState(
                step=torch.zeros((), dtype=torch.int32, device=dev),
                params=params, opt_state=opt.init(params))
            fn, args = step, (state, batch, CompressionState(error=()))
        elif kind == "prefill":
            fn, args = model.prefill, (params, batch)
        else:
            caches = fake_params(model.cache_defs(gb, seq), rules, mesh,
                                 dev)
            fn, args = model.decode_step, (params, batch, caches, seq - 1)
    return Cell(fn=fn, args=args, cfg=cfg, plan=(seq, gb, kind),
                fake_mode=fake, remat=rcfg.remat)


def count_cell(cell: Cell) -> Tuple[OpCost, Any, float]:
    """Run the cell's step once under its fake mode and a counter:
    (counts, outputs, seconds)."""
    t0 = time.time()
    with cell.fake_mode, torch.no_grad() if cell.plan[2] != "train" \
            else torch.enable_grad(), OpCost() as cost:
        out = cell.fn(*cell.args)
    return cost, out, time.time() - t0


def run_cell(arch: str, shape: str, *, multi_pod: bool = False,
             node: bool = False, rules=None, remat: str = "block",
             microbatches: int = 1, node_steps: int = 2, save: bool = True,
             tag: str = "", mesh=None, config=None, plan=None,
             device="cpu") -> Optional[Dict[str, Any]]:
    """Count one cell on ``mesh`` (default: the production mesh on a fake
    group) and return (and save) its report."""
    if mesh is None:
        mesh = production_mesh(multi_pod, torch.device(device).type)
    elif isinstance(mesh, str) and mesh == "none":   # mesh-less
        mesh = None
    n_dev = 1 if mesh is None else mesh.size()
    cell = build_cell(arch, shape, mesh, node=node, rules=rules,
                      remat=remat, microbatches=microbatches,
                      node_steps=node_steps, config=config, plan=plan,
                      device=device)
    if cell is None:
        return {"arch": arch, "shape": shape, "skipped": True,
                "reason": "full-attention arch skips long_500k"}
    seq, gb, kind = cell.plan
    cost, out, trace_s = count_cell(cell)
    roof = rl.analyze(cost, cell.cfg, kind, seq, gb, n_dev)
    result = {
        "arch": arch, "shape": shape, "kind": kind,
        "mesh": mesh_name(mesh),
        "node_mode": node,
        "remat": cell.remat,
        "seq": seq, "global_batch": gb,
        "n_devices": n_dev,
        "trace_s": round(trace_s, 2),
        "memory_analysis": {
            "argument_bytes": local_bytes(cell.args),
            "output_bytes": local_bytes(out),
            "temp_bytes": cost.peak_bytes,
            "generated_code_bytes": None,
        },
        "flops_by_dtype": dict(cost.flops_by_dtype),
        "kernels": {k: dict(v) for k, v in cost.kernels.items()},
        "coll_count": dict(cost.coll_count),
        "roofline": roof.to_dict(),
    }
    if save:
        d = os.path.join(RESULTS_DIR, result["mesh"])
        os.makedirs(d, exist_ok=True)
        suffix = f"__{tag}" if tag else ("__node" if node else "")
        with open(os.path.join(d, f"{arch}__{shape}{suffix}.json"),
                  "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--node", action="store_true",
                    help="continuous-depth (NODE/ACA) train mode")
    ap.add_argument("--remat", default="block", choices=["none", "block"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--tag", default="")
    ap.add_argument("--node-steps", type=int, default=2)
    ap.add_argument("--override", action="append", default=[],
                    help="logical=axis sharding-rule override, e.g. "
                         "res_seq=model or embed=none (repeatable)")
    args = ap.parse_args(argv)

    rules = DEFAULT_TRAIN_RULES
    for ov in args.override:
        k, v = ov.split("=")
        val = None if v.lower() in ("none", "null") else \
            (tuple(v.split("+")) if "+" in v else v)
        rules = rules.override(**{k: val})

    cells = []
    if args.all:
        for arch in ARCHS:
            if arch == "node18_cifar":
                continue        # covered by the dedicated --node rows
            for shape in SHAPES:
                # --shape with --all sweeps the archs at that shape
                if args.shape in (None, shape):
                    cells.append((arch, shape))
    else:
        if not (args.arch and args.shape):
            raise ValueError("dryrun: pass --arch and --shape, or --all")
        cells.append((args.arch, args.shape))
    mesh = production_mesh(args.multi_pod)
    n_fail = 0
    for arch, shape in cells:
        try:
            r = run_cell(arch, shape, mesh=mesh, node=args.node,
                         remat=args.remat, rules=rules,
                         microbatches=args.microbatches,
                         node_steps=args.node_steps, tag=args.tag)
            if r.get("skipped"):
                print(f"[skip] {arch} × {shape}: {r['reason']}")
                continue
            roof = r["roofline"]
            print(f"[ok]  {arch} × {shape} ({r['mesh']}): "
                  f"trace {r['trace_s']}s  "
                  f"t_comp={roof['t_compute']:.3e}s "
                  f"t_mem={roof['t_memory']:.3e}s "
                  f"t_coll={roof['t_collective']:.3e}s "
                  f"dom={roof['dominant']} "
                  f"frac={roof['roofline_fraction']:.2f}", flush=True)
        except Exception:
            n_fail += 1
            print(f"[FAIL] {arch} × {shape}")
            traceback.print_exc()
    if n_fail:
        raise SystemExit(f"{n_fail} cells failed")


if __name__ == "__main__":
    main()
