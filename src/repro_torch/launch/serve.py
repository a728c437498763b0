"""Serving launcher: batched prefill + decode for a ported arch.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma_9b \
        --smoke --prompt-len 32 --new-tokens 16 --device cpu

Port of ``repro/launch/serve.py`` with ``--device`` (default ``cuda``) and
``--use-pallas`` (the card kernels: K7 at every RMSNorm, K8, K9 and K10 in
prefill).
Weights are random at the reference's init scales, from a generator seeded
0 on the device; prompts from one seeded 1. A full config runs bf16 params
and compute, ``--smoke`` f32. It prints the reference's summary line.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.config import RunConfig
from repro_torch.models.lm import build_model
from repro_torch.serve import ServeConfig, ServeEngine


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--use-pallas", action="store_true",
                    help="run RMSNorm, prefill attention and the prefill "
                         "RG-LRU and SSD scans through the card kernels")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else \
        get_config(args.arch)
    dtype = torch.float32 if args.smoke else torch.bfloat16
    rcfg = RunConfig(compute_dtype=dtype, param_dtype=dtype,
                     use_pallas=args.use_pallas,
                     max_seq=args.prompt_len + args.new_tokens + 8)
    model = build_model(cfg, rcfg)
    params = model.init(seed=0, device=dev)
    engine = ServeEngine(model, params,
                         ServeConfig(max_new_tokens=args.new_tokens,
                                     temperature=args.temperature))
    toks = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                         generator=torch.Generator(device=dev).manual_seed(1),
                         device=dev, dtype=torch.int32)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.monotonic()
    out = engine.generate(
        toks, torch.Generator(device=dev).manual_seed(2))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.monotonic() - t0
    n_new = out["tokens"].shape[1] - args.prompt_len
    print(f"arch={cfg.name} generated {n_new} tokens x {args.batch} seqs "
          f"in {dt:.2f}s ({args.batch * n_new / dt:.1f} tok/s)")


if __name__ == "__main__":
    main()
