"""Train a continuous-depth (NODE) language model with ACA gradients: the
paper's ResNet -> NODE step applied to a transformer stack, through the
config registry, the token pipeline, AdamW with a cosine schedule,
clipping, atomic checkpoints with auto-resume and the straggler watch.
Port of ``examples/train_node_lm.py``.

Default: the ~100M-parameter node18_cifar config at (seq 128, batch 8)
for a few hundred steps. ``--smoke`` shrinks the model; ``--discrete``
trains the same stack without NODE mode; ``--grad-method`` switches
aca / adjoint / naive / mali. ``--adaptive`` trains with the paper's
``NODE_TRAIN`` (adaptive HeunEuler at rtol = atol = 1e-2, ACA, the fused
K1/K2 solver path, segmented checkpoints) in place of the fixed grid.

    PYTHONPATH=src python -m repro_torch.examples.train_node_lm --steps 300
    PYTHONPATH=src python -m repro_torch.examples.train_node_lm --smoke \\
        --steps 50 --adaptive --device cpu
"""

import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.node18_cifar import NODE_TRAIN
from repro_torch.core.node_block import NodeConfig
from repro_torch.data import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.models.config import RunConfig
from repro_torch.models.lm import build_model
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.train import TrainLoop, TrainLoopConfig, make_train_state


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--discrete", action="store_true")
    ap.add_argument("--grad-method", default="aca",
                    choices=["aca", "adjoint", "naive", "mali"])
    ap.add_argument("--adaptive", action="store_true",
                    help="the paper's adaptive NODE_TRAIN config "
                         "(HeunEuler 1e-2, the fused K1/K2 solver path)")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_node_lm"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke_config("node18_cifar") if args.smoke \
        else get_config("node18_cifar")
    if args.adaptive:
        node = dataclasses.replace(
            NODE_TRAIN, enabled=not args.discrete,
            grad_method=args.grad_method,
            # segmented checkpoints bound ACA's memory only: dropped when
            # the flag picks another method
            checkpoint_segments=(NODE_TRAIN.checkpoint_segments
                                 if args.grad_method == "aca" else None))
    else:
        node = NodeConfig(enabled=not args.discrete, regime="fixed",
                          solver="rk2", grad_method=args.grad_method,
                          steps_per_interval=2)
    rcfg = RunConfig(compute_dtype=torch.float32 if args.smoke
                     else torch.bfloat16, node=node)
    model = build_model(cfg, rcfg)
    mode = "discrete" if args.discrete else "NODE/" + args.grad_method
    print(f"model: {cfg.name}  params={model.n_params()/1e6:.1f}M  "
          f"mode={mode}")

    pipe = TokenPipeline(vocab=cfg.vocab, seq_len=args.seq,
                         global_batch=args.batch, seed=0, device=str(dev))
    opt = adamw(cosine_warmup(3e-4, 20, args.steps), weight_decay=0.1)
    lcfg = TrainLoopConfig(microbatches=1, clip_norm=1.0,
                           ckpt_dir=args.ckpt_dir, ckpt_every=100,
                           log_every=10)
    state = make_train_state(model, opt, seed=0, device=dev)
    loop = TrainLoop(model, opt, lcfg, state,
                     straggler_cb=lambda s, r: print(
                         f"  [straggler] step {s} {r:.1f}x slower"))
    if loop.step:
        print(f"resumed from checkpoint at step {loop.step}")

    loop.run(pipe.batch, args.steps,
             log_cb=lambda s, m: print(
                 f"step {s:5d}  loss {m['loss']:.4f}  "
                 f"gnorm {m['grad_norm']:.2f}"))
    print(f"done at step {loop.step}; checkpoints in {args.ckpt_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
