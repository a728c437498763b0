#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with a CUDA card. Phases, each
printing one JSON line (``"phase": ...``):

1. ``build``        — nvcc builds every kernel source of the port
                      (``src/repro_torch/kernels/csrc/*.cu``) into
                      ``build/repro_torch/``; build seconds and ptxas's
                      registers and spills per kernel.
2. ``kernels``      — K1 and K2 against their plain PyTorch versions on the
                      card at N = 3,145,728 (the node18 block's state) and
                      N = 1,000,003 (a ragged tail), f32 and bf16: z_next
                      bitwise, err and the norm sum within a relative
                      tolerance; times by CUDA events beside the byte bound.
3. ``toy_gradient`` — paper Fig. 6, the ACA column: dz/dt = kz through
                      ``odeint(..., use_pallas=True)``, against the
                      analytic gradient and the reference's step counts.
4. ``node18_block`` — one node18_cifar NODE block at full width (d_model
                      768, 12 heads, d_ff 3072, x (8, 512, 768) f32),
                      NODE_TRAIN's solver on the full checkpoint buffer,
                      three SGD steps through the fused kernels; then the
                      fused path against the plain path at the same width.
5. the ``kernels`` summary line, the card's name and power limit, and the
   last line ``{"ok": true, "device": {...}}``.

Any failure raises and the script exits non-zero without the last line.
Without a card, or without the port's sources beside it, it exits 2.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
NODE18_SHAPE = (8, 512, 768)
RAGGED_N = 1_000_003

# paper Fig. 6, ACA column: the reference's fused path on the CPU
# (rel err, n_steps, n_trials, nfe) at dopri5, rtol=atol=1e-5
TOY_REFERENCE = {
    (-2.0, 0.5): (5.7e-6, 4, 4, 27), (-2.0, 1.0): (1.8e-5, 6, 6, 39),
    (-2.0, 2.0): (9.3e-5, 10, 10, 63), (-2.0, 3.0): (5.2e-4, 13, 13, 81),
    (-2.0, 4.0): (2.8e-3, 15, 15, 93),
    (2.0, 0.5): (2.2e-6, 4, 4, 27), (2.0, 1.0): (4.7e-6, 6, 6, 39),
    (2.0, 2.0): (1.1e-5, 11, 11, 69), (2.0, 3.0): (1.6e-5, 16, 16, 99),
    (2.0, 4.0): (2.3e-5, 21, 21, 129),
}

# K2's err is the plain version's arithmetic in the same order (expected
# bitwise); its norm is summed per block then over blocks, the plain
# version's by one torch.sum: f32 summation order over N terms
ERR_RTOL = 1e-6
NORM_RTOL = 1e-5
# fused vs plain solve of the node18 block: the fused norm's summation
# order moves the error ratio, hence h, by ulps; z(1) and the ACA
# gradients follow by the same order
NODE_RTOL = 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class PhaseError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


# ------------------------------------------------------------------ timing

def time_ms(torch, fn, iters: int = 30, warmup: int = 5) -> float:
    """Mean device time of ``fn`` by CUDA events around each launch.

    Before each launch the card first spins ~1 ms (so the host has
    enqueued all of ``fn`` before the start event runs: host overhead is
    not timed) and then writes 128 MB (so ``fn`` finds the 50 MB L2 cold,
    as a solve's field evaluation leaves it between two stage kernels).
    """
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        torch.cuda._sleep(2_000_000)
        flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters


def used_rows(weights_list):
    """Stage rows a kernel reads: those with a nonzero weight in any of
    its weight rows (zero weights are skipped)."""
    return [j for j in range(len(weights_list[0]))
            if any(w[j] != 0.0 for w in weights_list)]


# ------------------------------------------------------------------ phases

def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    infos = build.build_all()
    seconds = time.perf_counter() - t0
    kernels = []
    for info in infos:
        current = None
        for line in info.log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                current = {"source": info.name, "entry": m.group(1)}
                kernels.append(current)
            m = re.search(r"Used (\d+) registers", line)
            if m and current is not None:
                current["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and current is not None:
                current["spill_stores"] = int(m.group(1))
                current["spill_loads"] = int(m.group(2))
    emit({"phase": "build", "ok": True, "seconds": seconds,
          "sources": [i.name for i in infos],
          "built_now": [i.name for i in infos if i.built],
          "kernels": kernels})


def phase_kernels(torch, seed: int):
    from repro_torch.core.tableaus import DOPRI5, HEUN_EULER
    from repro_torch.kernels import rk_stage
    gen = torch.Generator(device="cuda").manual_seed(seed)
    worst = {"rk_stage_increment": 0.0, "rk_stage_combine_err": 0.0}
    cases = []
    n_main = math.prod(NODE18_SHAPE)
    for n in (n_main, RAGGED_N):
        for dtype in (torch.float32, torch.bfloat16):
            z = torch.randn(n, generator=gen, device="cuda").to(dtype)
            k = torch.randn(7, n, generator=gen, device="cuda").to(dtype)
            h = torch.full((), 0.0375, device="cuda")
            rows = [("heun_euler", i, HEUN_EULER.a[i])
                    for i in range(1, HEUN_EULER.stages)]
            rows.append(("heun_euler", HEUN_EULER.stages, HEUN_EULER.b))
            rows += [("dopri5", i, DOPRI5.a[i])
                     for i in range(1, DOPRI5.stages)]
            rows.append(("dopri5", DOPRI5.stages, DOPRI5.b))
            for tab, i, a in rows:
                kk = k[:i].contiguous()
                out = rk_stage.rk_stage_increment(z, kk, h, a)
                ref = rk_stage.increment_plain(z, kk, h, a)
                torch.cuda.synchronize()
                diff = float((out.float() - ref.float()).abs().max())
                worst["rk_stage_increment"] = max(
                    worst["rk_stage_increment"], diff)
                check(torch.equal(out, ref),
                      f"K1 {tab} row {i} n={n} {dtype}: not bitwise equal "
                      f"to the plain version (max |diff| {diff})")
            for tab in (HEUN_EULER, DOPRI5):
                kk = k[:tab.stages].contiguous()
                for with_err in (True, False):
                    zn, err, part = rk_stage.rk_stage_combine_err(
                        z, kk, h, tab.b, tab.b_err, 1e-2, 1e-2,
                        with_err=with_err)
                    zn_p, err_p, sq_p = rk_stage.combine_err_plain(
                        z, kk, h, tab.b, tab.b_err, 1e-2, 1e-2, with_err)
                    torch.cuda.synchronize()
                    diff = float((zn.float() - zn_p.float()).abs().max())
                    check(torch.equal(zn, zn_p),
                          f"K2 {tab.name} n={n} {dtype} with_err={with_err}:"
                          f" z_next not bitwise equal (max |diff| {diff})")
                    sq, sqp = float(part.sum()), float(sq_p.sum())
                    check(abs(sq - sqp) <= NORM_RTOL * abs(sqp),
                          f"K2 {tab.name} n={n} {dtype}: norm {sq} vs {sqp}")
                    if with_err:
                        ed = float((err - err_p).abs().max())
                        check(ed <= ERR_RTOL * float(err_p.abs().max()),
                              f"K2 {tab.name} n={n} {dtype}: err |diff| {ed}")
                        diff = max(diff, ed)
                    worst["rk_stage_combine_err"] = max(
                        worst["rk_stage_combine_err"], diff)
            cases.append({"n": n, "dtype": str(dtype).replace("torch.", ""),
                          "k1_rows": len(rows), "bitwise": True})
    emit({"phase": "kernels", "ok": True, "cases": cases,
          "max_abs_err": worst, "err_rtol": ERR_RTOL,
          "norm_rtol": NORM_RTOL})

    # times at the main path's shape and type: node18's f32 state
    n = n_main
    z = torch.randn(n, generator=gen, device="cuda")
    k = torch.randn(7, n, generator=gen, device="cuda")
    h = torch.full((), 0.0375, device="cuda")
    timings = {}

    def k1_entry(label, a, rows_k):
        kk = k[:rows_k].contiguous()
        used = used_rows([a[:rows_k]])
        nbytes = 4 * n * (len(used) + 2) + 4
        flops = 2 * n * (len(used) + 1)
        hw = h * torch.tensor(a[:rows_k], dtype=torch.float32, device="cuda")
        kt = kk.t()
        timings[label] = {
            "ms": time_ms(torch, lambda: rk_stage.rk_stage_increment(
                z, kk, h, a)),
            "plain_ms": time_ms(torch, lambda: rk_stage.increment_plain(
                z, kk, h, a)),
            "library_ms": time_ms(torch, lambda: torch.addmv(z, kt, hw)),
            "bytes": nbytes, "flops": flops,
        }

    def k2_entry(label, tab, with_err):
        kk = k[:tab.stages].contiguous()
        used = used_rows([tab.b, tab.b_err])
        nbytes = 4 * n * (len(used) + 2 + (1 if with_err else 0)) + 4
        flops = n * (4 * len(used) + 12)
        timings[label] = {
            "ms": time_ms(torch, lambda: rk_stage.rk_stage_combine_err(
                z, kk, h, tab.b, tab.b_err, 1e-2, 1e-2,
                with_err=with_err)),
            "plain_ms": time_ms(torch, lambda: rk_stage.combine_err_plain(
                z, kk, h, tab.b, tab.b_err, 1e-2, 1e-2, with_err)),
            "library_ms": None,
            "bytes": nbytes, "flops": flops,
        }

    k1_entry("k1_heun_stage", HEUN_EULER.a[1], 1)      # trial loop
    k1_entry("k1_heun_b", HEUN_EULER.b, 2)             # ACA replay
    k1_entry("k1_dopri5_b", DOPRI5.b, 7)
    k2_entry("k2_heun", HEUN_EULER, False)             # trial loop
    k2_entry("k2_dopri5", DOPRI5, False)
    for t in timings.values():
        t["bound_ms"] = 1e3 * max(t["bytes"] / HBM_BYTES_PER_S,
                                  t["flops"] / F32_FLOP_PER_S)
        t["bound_by"] = ("bytes" if t["bytes"] / HBM_BYTES_PER_S
                         >= t["flops"] / F32_FLOP_PER_S else "operations")
        t["achieved_GBps"] = t["bytes"] / (t["ms"] * 1e-3) / 1e9
    emit({"phase": "kernel_times", "ok": True, "n": n, "dtype": "float32",
          "timings": timings})
    return worst, timings


def phase_toy_gradient(torch):
    from repro_torch.core import odeint
    from repro_torch.kernels import rk_stage
    z0v = 1.5
    rows = []
    rk_stage.reset_launches()
    for (k, t_end), (ref_err, ref_steps, ref_trials, ref_nfe) in \
            TOY_REFERENCE.items():
        z0 = torch.tensor(z0v, device="cuda", requires_grad=True)
        kk = torch.tensor(k, device="cuda")
        ys, st = odeint(lambda t, z, c: c * z, z0, [0.0, t_end], (kk,),
                        solver="dopri5", grad_method="aca", rtol=1e-5,
                        atol=1e-5, max_steps=512, use_pallas=True)
        (ys[-1] ** 2).sum().backward()
        analytic = 2 * z0v * math.exp(2 * k * t_end)
        err = abs(float(z0.grad) - analytic) / abs(analytic)
        row = {"k": k, "T": t_end, "rel_err": err, "ref_rel_err": ref_err,
               "n_steps": int(st.n_steps), "n_trials": int(st.n_trials),
               "nfe": int(st.nfe)}
        rows.append(row)
        check((row["n_steps"], row["n_trials"], row["nfe"])
              == (ref_steps, ref_trials, ref_nfe),
              f"toy k={k} T={t_end}: (n_steps, n_trials, nfe) "
              f"{(row['n_steps'], row['n_trials'], row['nfe'])} != "
              f"reference {(ref_steps, ref_trials, ref_nfe)}")
        check(err <= 2 * ref_err + 1e-6,
              f"toy k={k} T={t_end}: rel err {err} > 2 x {ref_err} + 1e-6")
    launches = dict(rk_stage.launches)
    check(all(v > 0 for v in launches.values()),
          f"toy solves did not launch every kernel: {launches}")
    emit({"phase": "toy_gradient", "ok": True, "cases": rows,
          "launches": launches})


def phase_node18(torch, seed: int):
    import numpy as np

    from repro_torch.configs import node18_cifar
    from repro_torch.kernels import rk_stage
    from repro_torch.models.config import RunConfig
    from repro_torch.models.transformer import (
        TransformerBlock,
        full_buffer,
        node_block,
    )
    import dataclasses

    ncfg = full_buffer(node18_cifar.NODE_TRAIN)
    rcfg = RunConfig(compute_dtype=torch.float32, node=ncfg)
    block = TransformerBlock(node18_cifar.CONFIG, rcfg, seed=seed,
                             device="cuda")
    x = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        NODE18_SHAPE).astype(np.float32)).cuda()
    opt = torch.optim.SGD(block.parameters(), lr=1e-2)
    steps = []
    torch.cuda.synchronize()
    rk_stage.reset_launches()              # the main path starts here
    for step in range(3):
        before = dict(rk_stage.launches)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        zT, st = node_block(block, x, ncfg)
        loss = torch.mean(zT ** 2)
        loss.backward()
        opt.step()
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        grads_finite = all(bool(torch.isfinite(p.grad).all())
                           for p in block.parameters())
        row = {"step": step, "loss": float(loss.detach()),
               "n_steps": int(st.n_steps), "n_trials": int(st.n_trials),
               "nfe": int(st.nfe), "status": int(st.status),
               "k1_launches": rk_stage.launches["rk_stage_increment"]
               - before["rk_stage_increment"],
               "k2_launches": rk_stage.launches["rk_stage_combine_err"]
               - before["rk_stage_combine_err"],
               "step_ms": 1e3 * step_s,
               "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9}
        steps.append(row)
        emit({"phase": "node18_step", **row})
        check(math.isfinite(row["loss"]) and grads_finite,
              f"node18 step {step}: non-finite loss or gradients")
        check(row["status"] == 0, f"node18 step {step}: status {row}")
    launches = dict(rk_stage.launches)     # the main path ends here
    check(all(v > 0 for v in launches.values()),
          f"the node18 steps did not launch every kernel: {launches}")

    # fused (kernels) against plain (tensor ops) at the same width
    results = {}
    for up in (True, False):
        cfg = dataclasses.replace(ncfg, use_pallas=up)
        for p in block.parameters():
            p.grad = None
        xg = x.clone().requires_grad_()
        zT, st = node_block(block, xg, cfg)
        torch.mean(zT ** 2).backward()
        results[up] = (zT.detach(), int(st.n_steps), xg.grad,
                       {n: p.grad.clone() for n, p in
                        block.named_parameters()})
    (z1, s1, gx1, gp1), (z0, s0, gx0, gp0) = results[True], results[False]

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    rels = {"z1": rel(z1, z0), "x": rel(gx1, gx0)}
    rels.update({n: rel(gp1[n], gp0[n]) for n in gp0})
    finite = all(bool(torch.isfinite(t).all())
                 for t in [z1, z0, gx1, gx0, *gp1.values(), *gp0.values()])
    emit({"phase": "node18_block", "ok": True,
          "shape": list(NODE18_SHAPE), "d_model": node18_cifar.CONFIG.d_model,
          "n_heads": node18_cifar.CONFIG.n_heads,
          "d_ff": node18_cifar.CONFIG.d_ff, "solver": ncfg.solver,
          "rtol": ncfg.rtol, "atol": ncfg.atol, "launches": launches,
          "fused_vs_plain": {"n_steps": [s1, s0], "max_rel": rels,
                             "rtol": NODE_RTOL, "finite": finite}})
    check(s1 == s0, f"node18 fused vs plain n_steps {s1} != {s0}")
    check(finite, "node18 fused vs plain: non-finite values")
    bad = {k: v for k, v in rels.items() if not v <= NODE_RTOL}
    check(not bad, f"node18 fused vs plain beyond {NODE_RTOL}: {bad}")
    return launches, steps


# -------------------------------------------------------------------- main

def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the random weights and inputs")
    args = parser.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this smoke runs only on a card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are not at {SRC}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    # full f32 matmuls on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase = "build"
    try:
        phase_build()
        phase = "kernels"
        worst, timings = phase_kernels(torch, args.seed)
        phase = "toy_gradient"
        phase_toy_gradient(torch)
        phase = "node18_block"
        launches, _ = phase_node18(torch, args.seed)
    except Exception as exc:
        emit({"phase": phase, "ok": False,
              "error": f"{type(exc).__name__}: {exc}"})
        raise

    entries = [
        ("rk_stage_increment", "src/repro/kernels/rk_stage.py:209",
         timings["k1_heun_stage"]),
        ("rk_stage_combine_err", "src/repro/kernels/rk_stage.py:269",
         timings["k2_heun"]),
    ]
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rk_stage.cu",
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": worst[name], "ms": t["ms"],
         "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
         "bound_by": t["bound_by"], "library_ms": t["library_ms"]}
        for name, replaces, t in entries]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi failed: {smi.stderr.strip()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
