"""Time K3, K4, K5, K7, K8, K9 or K10 on one NVIDIA card, in one source
tree or several.

    python3 tests/torch_k9_times.py [--kernel k3|k4|k5|k7|k8|k9|k10]
                                    [--src DIR ...] [--rounds N]

Each ``--src`` is the ``src`` directory of a checkout (default: this
one's), for example a ``git archive`` of an earlier commit unpacked into
the git-ignored ``build/``. All trees run on the same inputs, in turns (A,
B, then B, A, per pair of rounds). Each time is the mean of 10 launches
(K7: 30) by CUDA events with a cold L2 (``chip_smoke.time_ms``).

* ``k9`` (default): mamba2_2_7b's call A prefill, x (4, 4096, 80, 64)
  bf16, one group of state 128, chunk 256, at the reference init
  (``chip_smoke._ssd_inputs``). Where a tree has the three-kernel bf16
  design (``ssd_scan.PARTS``), each kernel is also timed alone on the
  outputs of the one before it, and where it has two kernels for the
  third (``ssd_scan.KERNELS``), each of them forced.
* ``k7``: RMSNorm in bf16 at the decode rows (4, D) of D = 4096 (the
  RecurrentGemma width), 2560 and 5120 (the Mamba-2 widths) and at call
  A's prefill rows (16384, 4096). Where a tree has K7's two kernels
  (``rmsnorm.KERNELS``), each is also timed alone, and the no-op kernel
  (``rmsnorm.noop``) gives the launch floor.
* ``k8``: flash attention in bf16 at recurrentgemma_9b's prefill, q (4,
  16, 4096, 256), one kv head, window 2048 and 0 (causal); causal at
  qwen2_72b's and command_r_35b's layout, q (4, 64, 4096, 128) with 8 kv
  heads, and at musicgen_medium's call, q (2, 24, 1024, 64).
* ``k10``: the RG-LRU scan in f32 at recurrentgemma_9b's prefill shapes
  (4, 4096, 4096) and (2, 1000, 4096) (calls A and B), log_a = -softplus
  of a normal draw, as ``chip_smoke.py`` draws it.
* ``k3``: the batched stage increment in f32 with HeunEuler's one stage
  (every trial) at the serving state (8, 393,218) and the batched block
  state (8, 393,216), and K1, which shares its row code, with the same
  stage at the node18 block state N = 3,145,728.
* ``k4``, ``k5``: the batched combine with its norm partials in f32 with
  HeunEuler's weights at the serving state (8, 393,218) and the batched
  block state (8, 393,216): K4 at scalar tolerances (1e-2), K5 at (B,)
  tolerances from 1e-2 to 1e-4.

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
    """The ``ops``, ``ssd_scan``, ``rmsnorm`` and ``rk_stage`` modules of
    the port under ``src``, imported afresh (the modules of an earlier tree
    stay in use by the functions that hold them)."""
    for name in list(sys.modules):
        if name == "repro_torch" or name.startswith("repro_torch."):
            del sys.modules[name]
    sys.path.insert(0, src)
    try:
        return tuple(importlib.import_module(f"repro_torch.kernels.{m}")
                     for m in ("ops", "ssd_scan", "rmsnorm", "rk_stage"))
    finally:
        sys.path.remove(src)


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
        for kern in getattr(k9, "KERNELS", ()):
            out[f"ssd_chunk_scan_{kern}_ms"] = time_ms(
                lambda kern=kern: k9.ssd_chunk_scan(
                    x, dt, cs, bm, cm, states, CHUNK, kernel=kern))
        out["parts_sum_ms"] = sum(out[f"{p}_ms"] for p in k9.PARTS)
    return out


K7_SHAPES = ((4, 4096), (4, 2560), (4, 5120), (16384, 4096))
# (batch, heads, kv heads, length, head dim), windows
K8_CASES = (((4, 16, 1, 4096, 256), (2048, 0)),
            ((4, 64, 8, 4096, 128), (0,)),
            ((2, 24, 24, 1024, 64), (0,)))


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
    """One (q, k, v) a case of K8_CASES, bf16."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [[torch.randn(*shape, generator=gen, device="cuda").to(
        torch.bfloat16) for shape in ((b, h, s, dh), (b, hkv, s, dh),
                                      (b, hkv, s, dh))]
            for (b, h, hkv, s, dh), _ in K8_CASES]


def time_k8(ops, data) -> dict:
    out = {}
    for (q, k, v), (_, windows) in zip(data, K8_CASES):
        key = "x".join(map(str, q.shape)) + f"_kv{k.shape[1]}"
        for w in windows:
            out[f"{key}_window_{w}_ms"] = time_ms(
                lambda q=q, k=k, v=v, w=w: ops.flash_attention(
                    q, k, v, window=w))
    return out


K10_SHAPES = ((4, 4096, 4096), (2, 1000, 4096))


def k10_inputs(seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [(-torch.nn.functional.softplus(torch.randn(
        *shape, generator=gen, device="cuda")), torch.randn(
        *shape, generator=gen, device="cuda")) for shape in K10_SHAPES]


def time_k10(ops, data) -> dict:
    return {f"{'x'.join(map(str, la.shape))}_ms": time_ms(
        lambda la=la, x=x: ops.rg_lru(la, x)) for la, x in data}


K3_ROWS, K3_NS, K1_N = 8, (393_218, 393_216), 3_145_728
HEUN_STAGE = (1.0,)   # HeunEuler's a[1]: the stage of every trial


def k3_inputs(seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    data = []
    for n in K3_NS:
        z = torch.randn(K3_ROWS, n, generator=gen, device="cuda")
        k = torch.randn(1, K3_ROWS, n, generator=gen, device="cuda")
        data.append((z, k, torch.linspace(0.01, 0.08, K3_ROWS,
                                          device="cuda")))
    z = torch.randn(K1_N, generator=gen, device="cuda")
    k = torch.randn(1, K1_N, generator=gen, device="cuda")
    return data, (z, k, torch.full((), 0.05, device="cuda"))


def time_k3(rk, data) -> dict:
    rows, solo = data
    out = {f"k3_{z.shape[0]}x{z.shape[1]}_ms": _time_ms(
        torch, lambda z=z, k=k, h=h: rk.rk_stage_increment_batched(
            z, k, h, HEUN_STAGE)) for z, k, h in rows}
    z, k, h = solo
    out[f"k1_{z.shape[0]}_ms"] = _time_ms(
        torch, lambda: rk.rk_stage_increment(z, k, h, HEUN_STAGE))
    return out


HEUN_B, HEUN_E = (0.5, 0.5), (-0.5, 0.5)   # HeunEuler's b and b - b_hat


def k45_inputs(seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    data = []
    for n in K3_NS:
        z = torch.randn(K3_ROWS, n, generator=gen, device="cuda")
        k = torch.randn(2, K3_ROWS, n, generator=gen, device="cuda")
        h = torch.linspace(0.01, 0.08, K3_ROWS, device="cuda")
        rt = torch.logspace(-2, -4, K3_ROWS, device="cuda")
        data.append((z, k, h, rt, 0.1 * rt))
    return data


def time_k45(rk, data, kernel: str) -> dict:
    out = {}
    for z, k, h, rt, at in data:
        if kernel == "k4":
            def fn(z=z, k=k, h=h):
                return rk.rk_stage_combine_err_batched(
                    z, k, h, HEUN_B, HEUN_E, 1e-2, 1e-2)
        else:
            def fn(z=z, k=k, h=h, rt=rt, at=at):
                return rk.rk_stage_combine_err_batched_rowtol(
                    z, k, h, HEUN_B, HEUN_E, rt, at)
        out[f"{kernel}_{z.shape[0]}x{z.shape[1]}_ms"] = _time_ms(torch, fn)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernel",
                        choices=("k3", "k4", "k5", "k7", "k8", "k9", "k10"),
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
    dtype = "bfloat16"
    if args.kernel == "k9":
        data = inputs(args.seed)
        what = {"shape": list(SHAPE), "state": STATE, "chunk": CHUNK}
    elif args.kernel == "k7":
        data = k7_inputs(args.seed)
        what = {"shapes": [list(s) for s in K7_SHAPES]}
    elif args.kernel == "k8":
        data = k8_inputs(args.seed)
        what = {"cases": [[list(s), list(w)] for s, w in K8_CASES]}
    elif args.kernel == "k10":
        data, dtype = k10_inputs(args.seed), "float32"
        what = {"shapes": [list(s) for s in K10_SHAPES]}
    elif args.kernel == "k3":
        data, dtype = k3_inputs(args.seed), "float32"
        what = {"rows": K3_ROWS, "ns": list(K3_NS), "k1_n": K1_N,
                "stage": list(HEUN_STAGE)}
    else:
        data, dtype = k45_inputs(args.seed), "float32"
        what = {"rows": K3_ROWS, "ns": list(K3_NS), "b": list(HEUN_B),
                "e": list(HEUN_E)}
    for r in range(args.rounds):
        order = list(range(len(trees)))
        for i in (order if r % 2 == 0 else order[::-1]):
            ops, k9, k7, rk = trees[i]
            if args.kernel == "k9":
                times = time_tree(ops, k9, *data)
            elif args.kernel == "k7":
                times = time_k7(ops, k7, data)
            elif args.kernel == "k8":
                times = time_k8(ops, data)
            elif args.kernel == "k10":
                times = time_k10(ops, data)
            elif args.kernel == "k3":
                times = time_k3(rk, data)
            else:
                times = time_k45(rk, data, args.kernel)
            print(json.dumps({"kernel": args.kernel, "tree": srcs[i],
                              "round": r, **what, "dtype": dtype,
                              **times}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip() or smi.stderr.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
