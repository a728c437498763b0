"""Training launcher: ``--arch <id>`` selects any registry config.

    PYTHONPATH=src python -m repro_torch.launch.train --arch node18_cifar \\
        --smoke --steps 50 [--node] [--grad-method aca] [--device cpu]

Port of ``repro/launch/train.py``. ``--smoke`` takes the reduced
same-family config in f32; without it the full config is built in bf16
compute. ``--node`` turns every block into an ODE block (fixed grid, two
rk2 steps, ``--grad-method``); frontend archs (vlm, audio) are fed
``frontend_batch_synthetic`` batches, the others ``TokenPipeline``'s.
Checkpoints go to ``--ckpt-dir`` (atomic, auto-resumed); the loss is
logged every 10 steps, and at the end of a shorter run.

``--mesh`` trains on the reference's elastic mesh: run under torchrun,
one process a rank (``init_distributed``: NCCL on cards, gloo with
``--device cpu``), a ``(pod, data, model=1)`` mesh over the live world
(``make_elastic_mesh(model_parallel=1)``), parameters, optimizer moments
and activations placed on it by the logical-axis rules; every rank draws
the same global batch and keeps its rows. With ``--node`` each rank
solves its rows' NODE blocks on the whole batch's grid::

    torchrun --nproc-per-node 8 -m repro_torch.launch.train \
        --arch node18_cifar --smoke --mesh --node --device cpu
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.node_block import NodeConfig
from repro_torch.data import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import init_distributed, make_elastic_mesh
from repro_torch.models.config import RunConfig
from repro_torch.models.frontends import frontend_batch_synthetic
from repro_torch.models.lm import build_model
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.train import TrainLoop, TrainLoopConfig, make_train_state


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--node", action="store_true")
    ap.add_argument("--grad-method", default="aca",
                    choices=["aca", "adjoint", "naive"])
    ap.add_argument("--compression", default="none",
                    choices=["none", "int8", "topk"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--mesh", action="store_true",
                    help="an elastic (pod, data, model=1) mesh over the "
                         "process group's ranks (run under torchrun)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    mesh, rank = None, 0
    if args.mesh:
        dtype = torch.device(args.device).type
        rank, _ = init_distributed(dtype)
        mesh = make_elastic_mesh(model_parallel=1, device_type=dtype)
    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else \
        get_config(args.arch)
    node = NodeConfig(enabled=args.node, regime="fixed", solver="rk2",
                      grad_method=args.grad_method, steps_per_interval=2)
    rcfg = RunConfig(mesh=mesh, compute_dtype=torch.float32 if args.smoke
                     else torch.bfloat16, node=node)
    model = build_model(cfg, rcfg)
    say = print if rank == 0 else (lambda *a, **k: None)
    shape = None if mesh is None else dict(zip(mesh.mesh_dim_names,
                                                mesh.shape))
    say(f"arch={cfg.name} params={model.n_params()/1e6:.1f}M "
        f"node={args.node} mesh={shape}")

    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=args.seq,
                         global_batch=args.batch, device=str(dev))

    def batch_fn(step):
        if cfg.frontend != "none":
            return frontend_batch_synthetic(
                cfg, args.batch, args.seq, seed=step,
                compute_dtype=rcfg.compute_dtype, device=dev)
        return pipe.batch(step)

    opt = adamw(cosine_warmup(3e-4, 20, max(args.steps, 100)),
                weight_decay=0.1)
    lcfg = TrainLoopConfig(microbatches=args.microbatches,
                           compression=args.compression,
                           ckpt_dir=args.ckpt_dir, ckpt_every=100,
                           log_every=min(10, args.steps))
    state = make_train_state(model, opt, seed=0, device=dev)
    loop = TrainLoop(model, opt, lcfg, state)
    loop.run(batch_fn, args.steps,
             log_cb=lambda s, m: say(
                 f"step {s:5d} loss {m['loss']!r} "
                 f"gnorm {m['grad_norm']:.2f}"))
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()


if __name__ == "__main__":
    main()
