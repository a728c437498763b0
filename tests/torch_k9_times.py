"""Time K7, K8 or K9 on one NVIDIA card, in one source tree or several.

    python3 tests/torch_k9_times.py [--kernel k7|k8|k9] [--src DIR ...]
                                    [--rounds N]

Each ``--src`` is the ``src`` directory of a checkout (default: this
one's), for example a ``git archive`` of an earlier commit unpacked into
the git-ignored ``build/``. All trees run on the same inputs, in turns (A,
B, then B, A, per pair of rounds). Each time is the mean of 10 launches
(K7: 30) by CUDA events with a cold L2 (``chip_smoke.time_ms``).

* ``k9`` (default): mamba2_2_7b's call A prefill, x (4, 4096, 80, 64)
  bf16, one group of state 128, chunk 256, at the reference init
  (``chip_smoke._ssd_inputs``). Where a tree has the three-kernel bf16
  design (``ssd_scan.PARTS``), each kernel is also timed alone on the
  outputs of the one before it.
* ``k7``: RMSNorm in bf16 at the decode rows (4, D) of D = 4096 (the
  RecurrentGemma width), 2560 and 5120 (the Mamba-2 widths) and at call
  A's prefill rows (16384, 4096). Where a tree has K7's two kernels
  (``rmsnorm.KERNELS``), each is also timed alone, and the no-op kernel
  (``rmsnorm.noop``) gives the launch floor.
* ``k8``: flash attention in bf16 at recurrentgemma_9b's prefill, q (4,
  16, 4096, 256), one kv head, window 2048 and 0 (causal).

Prints one JSON line per tree and round, then the card's name and power
limit.
"""

import argparse
import importlib
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import _ssd_inputs  # noqa: E402
from chip_smoke import time_ms as _time_ms  # noqa: E402

SHAPE = (4, 4096, 80, 64)   # batch, length, heads, head dim
STATE, CHUNK = 128, 256


def time_ms(fn, prep=None) -> float:
    return _time_ms(torch, fn, iters=10, warmup=2, prep=prep)


def load_tree(src: str):
    """The ``ops``, ``ssd_scan`` and ``rmsnorm`` modules of the port under
    ``src``, imported afresh (the modules of an earlier tree stay in use by
    the functions that hold them)."""
    for name in list(sys.modules):
        if name == "repro_torch" or name.startswith("repro_torch."):
            del sys.modules[name]
    sys.path.insert(0, src)
    try:
        ops = importlib.import_module("repro_torch.kernels.ops")
        k9 = importlib.import_module("repro_torch.kernels.ssd_scan")
        k7 = importlib.import_module("repro_torch.kernels.rmsnorm")
    finally:
        sys.path.remove(src)
    return ops, k9, k7


def inputs(seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return _ssd_inputs(torch, gen, *SHAPE, 1, STATE, torch.bfloat16)


def time_tree(ops, k9, x, dt, a, bm, cm) -> dict:
    out = {"ssd_scan_ms": time_ms(
        lambda: ops.ssd_scan(x, dt, a, bm, cm, CHUNK))}
    if hasattr(k9, "PARTS"):
        cs, states = k9.ssd_chunk_state(x, dt, a, bm, CHUNK)
        saved = states.clone()
        out["ssd_chunk_state_ms"] = time_ms(
            lambda: k9.ssd_chunk_state(x, dt, a, bm, CHUNK))
        out["ssd_state_pass_ms"] = time_ms(
            lambda: k9.ssd_state_pass(states, cs, CHUNK),
            prep=lambda: states.copy_(saved))
        states.copy_(saved)
        k9.ssd_state_pass(states, cs, CHUNK)
        out["ssd_chunk_scan_ms"] = time_ms(
            lambda: k9.ssd_chunk_scan(x, dt, cs, bm, cm, states, CHUNK))
        out["parts_sum_ms"] = sum(out[f"{p}_ms"] for p in k9.PARTS)
    return out


K7_SHAPES = ((4, 4096), (4, 2560), (4, 5120), (16384, 4096))
K8_SHAPE, K8_WINDOWS = (4, 16, 4096, 256), (2048, 0)


def k7_inputs(seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [(torch.randn(r, d, generator=gen, device="cuda").to(
        torch.bfloat16), torch.randn(d, generator=gen, device="cuda").to(
        torch.bfloat16)) for r, d in K7_SHAPES]


def time_k7(ops, k7, data) -> dict:
    out = {}
    if hasattr(k7, "noop"):
        out["launch_floor_ms"] = _time_ms(torch, lambda: k7.noop("cuda"))
    for x, w in data:
        key = "x".join(map(str, x.shape))
        out[f"{key}_ms"] = _time_ms(torch, lambda: ops.rmsnorm(x, w))
        for k in getattr(k7, "KERNELS", ()):
            out[f"{key}_{k}_ms"] = _time_ms(
                torch, lambda k=k: k7.rmsnorm(x, w, kernel=k))
    return out


def k8_inputs(seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, h, s, dh = K8_SHAPE
    return [torch.randn(*shape, generator=gen, device="cuda").to(
        torch.bfloat16) for shape in ((b, h, s, dh), (b, 1, s, dh),
                                      (b, 1, s, dh))]


def time_k8(ops, q, k, v) -> dict:
    return {f"window_{w}_ms": time_ms(
        lambda w=w: ops.flash_attention(q, k, v, window=w))
        for w in K8_WINDOWS}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel", choices=("k7", "k8", "k9"),
                        default="k9")
    parser.add_argument("--src", action="append",
                        help="src directory of a tree (repeatable)")
    parser.add_argument("--rounds", type=int, default=2)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_k9_times: no CUDA device", file=sys.stderr)
        return 2
    srcs = args.src or [str(ROOT / "src")]
    trees = [load_tree(str(Path(s).resolve())) for s in srcs]
    if args.kernel == "k9":
        data = inputs(args.seed)
        what = {"shape": list(SHAPE), "state": STATE, "chunk": CHUNK}
    elif args.kernel == "k7":
        data = k7_inputs(args.seed)
        what = {"shapes": [list(s) for s in K7_SHAPES]}
    else:
        data = k8_inputs(args.seed)
        what = {"shape": list(K8_SHAPE), "kv_heads": 1,
                "windows": list(K8_WINDOWS)}
    for r in range(args.rounds):
        order = list(range(len(trees)))
        for i in (order if r % 2 == 0 else order[::-1]):
            ops, k9, k7 = trees[i]
            if args.kernel == "k9":
                times = time_tree(ops, k9, *data)
            elif args.kernel == "k7":
                times = time_k7(ops, k7, data)
            else:
                times = time_k8(ops, *data)
            print(json.dumps({"kernel": args.kernel, "tree": srcs[i],
                              "round": r, **what, "dtype": "bfloat16",
                              **times}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
