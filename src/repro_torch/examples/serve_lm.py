"""Serve a small LM with batched requests: prefill, then autoregressive
decode over the fixed-capacity cache engine. Port of
``examples/serve_lm.py``.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
"""

import argparse

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.config import RunConfig
from repro_torch.models.lm import build_model
from repro_torch.serve import ServeConfig, ServeEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_smoke_config("qwen2_72b")
    model = build_model(cfg, RunConfig(compute_dtype=torch.float32,
                                       max_seq=64))
    params = model.init(seed=0, device=dev)
    engine = ServeEngine(model, params,
                         ServeConfig(max_new_tokens=16, temperature=0.0))

    # a batch of 4 "requests" (random prompts: the engine mechanics are
    # the point; the weights are untrained)
    prompts = torch.randint(0, cfg.vocab, (4, 12), device=dev,
                            dtype=torch.int32,
                            generator=torch.Generator(dev).manual_seed(1))
    out = engine.generate(prompts)
    print("prompt shape:", tuple(prompts.shape), "-> output shape:",
          tuple(out["tokens"].shape))
    for i, row in enumerate(out["tokens"]):
        print(f"req {i}: ...{row[-16:].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
