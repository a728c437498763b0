"""Time K9, the Mamba-2 SSD chunk scan, on one NVIDIA card, in one source
tree or several.

    python3 tests/torch_k9_times.py [--src DIR ...] [--rounds N]

Each ``--src`` is the ``src`` directory of a checkout (default: this
one's), for example a ``git archive`` of an earlier commit unpacked into
the git-ignored ``build/``. All trees run on the same inputs, in turns (A,
B, then B, A, per pair of rounds): mamba2_2_7b's call A prefill, x (4,
4096, 80, 64) bf16, one group of state 128, chunk 256, at the reference
init (``chip_smoke._ssd_inputs``). Each time is the mean of 10 launches by
CUDA events with a cold L2 (``chip_smoke.time_ms``). Where a tree
has the three-kernel bf16 design (``ssd_scan.PARTS``), each kernel is also
timed alone on the outputs of the one before it. Prints one JSON line per
tree and round, then the card's name and power limit.
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
    """The ``ops`` and ``ssd_scan`` modules of the port under ``src``,
    imported afresh (the modules of an earlier tree stay in use by the
    functions that hold them)."""
    for name in list(sys.modules):
        if name == "repro_torch" or name.startswith("repro_torch."):
            del sys.modules[name]
    sys.path.insert(0, src)
    try:
        ops = importlib.import_module("repro_torch.kernels.ops")
        k9 = importlib.import_module("repro_torch.kernels.ssd_scan")
    finally:
        sys.path.remove(src)
    return ops, k9


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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
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
    data = inputs(args.seed)
    for r in range(args.rounds):
        order = list(range(len(trees)))
        for i in (order if r % 2 == 0 else order[::-1]):
            ops, k9 = trees[i]
            print(json.dumps({"tree": srcs[i], "round": r,
                              "shape": list(SHAPE), "state": STATE,
                              "chunk": CHUNK, "dtype": "bfloat16",
                              **time_tree(ops, k9, *data)}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
