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
5. ``kernels_batched`` — K3, K4 and K5 against their plain versions on the
                      card at (8, 393,216) and (8, 393,218) (the serving
                      state [z, t_off, delta], whose rows start unaligned),
                      f32 and bf16, HeunEuler and Dopri5 rows: z_next
                      bitwise, per-row norms within a relative tolerance,
                      h = 0 rows bitwise, K5 at K4's tolerance bitwise
                      K4; times beside the byte bound, the plain version
                      and ``torch.baddbmm``.
6. ``serve_node18``  — ``NodeServeEngine`` over the node18 block's residual
                      branch at full width: 8 slots, HeunEuler, 16 seeded
                      requests with per-request tolerances and Poisson
                      arrivals; every request against a one-shot solo
                      solve, and one request alone against the mix, bit
                      for bit.
7. ``node18_batched`` — the node18 block with NodeConfig(batch_axis=0) on x
                      (8, 512, 768): every sample on its own grid, two SGD
                      steps; then fused against plain at the same width.
8. the ``kernels`` summary line (K1-K5), the card's name and power limit,
   and the last line ``{"ok": true, "device": {...}}``.

Each main path (node18_block for K1/K2, serve_node18 for K3/K5,
node18_batched for K3/K4) runs with the launch counts set to 0 just
before it and read just after.

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
# per-sample rows of the batched paths: one (512, 768) sample, and the
# serving state [z, t_off, delta] two values wider
BATCH_ROWS = NODE18_SHAPE[0]
ROW_N = NODE18_SHAPE[1] * NODE18_SHAPE[2]
SERVE_ROW_N = ROW_N + 2
SERVE_REQUESTS = 16

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
# per-row norms of K4/K5 (block partials summed per row) against the plain
# version's one torch.sum per row over N terms
ROW_NORM_RTOL = 1e-6

K1_K2 = ("rk_stage_increment", "rk_stage_combine_err")
SERVE_KERNELS = ("rk_stage_increment_batched",
                 "rk_stage_combine_err_batched_rowtol")
BATCHED_KERNELS = ("rk_stage_increment_batched",
                   "rk_stage_combine_err_batched")


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
    launches = {k: rk_stage.launches[k] for k in K1_K2}
    check(all(v > 0 for v in launches.values()),
          f"toy solves did not launch K1 and K2: {launches}")
    emit({"phase": "toy_gradient", "ok": True, "cases": rows,
          "launches": launches})


def _node18_train(torch, seed: int, ncfg, n_train: int, kernels,
                  phase: str):
    """The node18 block at full width under ``ncfg``: ``n_train`` SGD
    steps (the main path, launch counts set to 0 before it and read after
    it; ``kernels`` must each launch), then the fused path against the
    plain path at the same width. Returns (launches, step rows)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import node18_cifar
    from repro_torch.kernels import rk_stage
    from repro_torch.models.config import RunConfig
    from repro_torch.models.transformer import TransformerBlock, node_block

    rcfg = RunConfig(compute_dtype=torch.float32, node=ncfg)
    block = TransformerBlock(node18_cifar.CONFIG, rcfg, seed=seed,
                             device="cuda")
    x = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        NODE18_SHAPE).astype(np.float32)).cuda()
    opt = torch.optim.SGD(block.parameters(), lr=1e-2)
    steps = []
    torch.cuda.synchronize()
    rk_stage.reset_launches()              # the main path starts here
    for step in range(n_train):
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
        # per-row lists under batch_axis, numbers for the solo solve
        row = {"step": step, "loss": float(loss.detach()),
               "n_steps": st.n_steps.tolist(),
               "n_trials": st.n_trials.tolist(), "nfe": st.nfe.tolist(),
               "status": st.status.tolist(),
               "launches": {k: rk_stage.launches[k] - before[k]
                            for k in kernels},
               "step_ms": 1e3 * step_s,
               "peak_mem_GB": torch.cuda.max_memory_allocated() / 1e9}
        steps.append(row)
        emit({"phase": f"{phase}_step", **row})
        check(math.isfinite(row["loss"]) and grads_finite,
              f"{phase} step {step}: non-finite loss or gradients")
        check(not any(st.status.reshape(-1).tolist()),
              f"{phase} step {step}: status {row['status']}")
    launches = dict(rk_stage.launches)     # the main path ends here
    check(all(launches[k] > 0 for k in kernels),
          f"the {phase} steps did not launch {kernels}: {launches}")

    # fused (kernels) against plain (tensor ops) at the same width
    results = {}
    for up in (True, False):
        cfg = dataclasses.replace(ncfg, use_pallas=up)
        for p in block.parameters():
            p.grad = None
        xg = x.clone().requires_grad_()
        zT, st = node_block(block, xg, cfg)
        torch.mean(zT ** 2).backward()
        results[up] = (zT.detach(), st.n_steps.tolist(), xg.grad,
                       {n: p.grad.clone() for n, p in
                        block.named_parameters()})
    (z1, s1, gx1, gp1), (z0, s0, gx0, gp0) = results[True], results[False]

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    rels = {"z1": rel(z1, z0), "x": rel(gx1, gx0)}
    rels.update({n: rel(gp1[n], gp0[n]) for n in gp0})
    finite = all(bool(torch.isfinite(t).all())
                 for t in [z1, z0, gx1, gx0, *gp1.values(), *gp0.values()])
    emit({"phase": phase, "ok": True,
          "shape": list(NODE18_SHAPE), "d_model": node18_cifar.CONFIG.d_model,
          "n_heads": node18_cifar.CONFIG.n_heads,
          "d_ff": node18_cifar.CONFIG.d_ff, "batch_axis": ncfg.batch_axis,
          "solver": ncfg.solver, "rtol": ncfg.rtol, "atol": ncfg.atol,
          "launches": {k: launches[k] for k in launches if launches[k]},
          "fused_vs_plain": {"n_steps": [s1, s0], "max_rel": rels,
                             "rtol": NODE_RTOL, "finite": finite}})
    check(s1 == s0, f"{phase} fused vs plain n_steps {s1} != {s0}")
    check(finite, f"{phase} fused vs plain: non-finite values")
    bad = {k: v for k, v in rels.items() if not v <= NODE_RTOL}
    check(not bad, f"{phase} fused vs plain beyond {NODE_RTOL}: {bad}")
    return launches, steps


def phase_node18(torch, seed: int):
    from repro_torch.configs import node18_cifar
    from repro_torch.models.transformer import full_buffer
    return _node18_train(torch, seed, full_buffer(node18_cifar.NODE_TRAIN),
                         3, K1_K2, "node18_block")


def phase_kernels_batched(torch, seed: int):
    from repro_torch.core.tableaus import DOPRI5, HEUN_EULER
    from repro_torch.kernels import rk_stage
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    worst = {"rk_stage_increment_batched": 0.0,
             "rk_stage_combine_err_batched": 0.0,
             "rk_stage_combine_err_batched_rowtol": 0.0}
    B, frozen = BATCH_ROWS, 3
    rt = torch.logspace(-2, -4, B, device="cuda")
    at = 0.1 * rt
    cases = []

    def norms_close(part, sq_plain, what):
        sq = part.sum(dim=-1)
        bad = (sq - sq_plain).abs() > ROW_NORM_RTOL * sq_plain.abs()
        check(not bool(bad.any()),
              f"{what}: per-row norms {sq.tolist()} vs plain "
              f"{sq_plain.tolist()}")

    for n in (ROW_N, SERVE_ROW_N):
        for dtype in (torch.float32, torch.bfloat16):
            z = torch.randn(B, n, generator=gen, device="cuda").to(dtype)
            k = torch.randn(7, B, n, generator=gen, device="cuda").to(dtype)
            h = torch.linspace(0.01, 0.08, B, device="cuda")
            h[frozen] = 0.0                      # a frozen row
            rows = [("heun_euler", i, HEUN_EULER.a[i])
                    for i in range(1, HEUN_EULER.stages)]
            rows.append(("heun_euler", HEUN_EULER.stages, HEUN_EULER.b))
            rows += [("dopri5", i, DOPRI5.a[i])
                     for i in range(1, DOPRI5.stages)]
            rows.append(("dopri5", DOPRI5.stages, DOPRI5.b))
            tag = f"n={n} {dtype}"
            for tab, i, a in rows:
                kk = k[:i].contiguous()
                out = rk_stage.rk_stage_increment_batched(z, kk, h, a)
                ref = rk_stage.increment_batched_plain(z, kk, h, a)
                torch.cuda.synchronize()
                diff = float((out.float() - ref.float()).abs().max())
                worst["rk_stage_increment_batched"] = max(
                    worst["rk_stage_increment_batched"], diff)
                check(torch.equal(out, ref),
                      f"K3 {tab} row {i} {tag}: not bitwise equal to the "
                      f"plain version (max |diff| {diff})")
                check(torch.equal(out[frozen], z[frozen]),
                      f"K3 {tab} row {i} {tag}: the h = 0 row moved")
            for tab in (HEUN_EULER, DOPRI5):
                kk = k[:tab.stages].contiguous()
                args = (z, kk, h, tab.b, tab.b_err)
                zn4, p4 = rk_stage.rk_stage_combine_err_batched(
                    *args, 1e-2, 1e-2)
                zp, sqp = rk_stage.combine_err_batched_plain(
                    *args, 1e-2, 1e-2)
                torch.cuda.synchronize()
                diff = float((zn4.float() - zp.float()).abs().max())
                worst["rk_stage_combine_err_batched"] = max(
                    worst["rk_stage_combine_err_batched"], diff)
                check(torch.equal(zn4, zp),
                      f"K4 {tab.name} {tag}: z_next not bitwise equal "
                      f"(max |diff| {diff})")
                norms_close(p4, sqp, f"K4 {tab.name} {tag}")
                check(torch.equal(zn4[frozen], z[frozen])
                      and float(p4[frozen].abs().sum()) == 0.0,
                      f"K4 {tab.name} {tag}: the h = 0 row moved")
                zn5, p5 = rk_stage.rk_stage_combine_err_batched_rowtol(
                    *args, torch.full((B,), 1e-2, device="cuda"),
                    torch.full((B,), 1e-2, device="cuda"))
                torch.cuda.synchronize()
                check(torch.equal(zn5, zn4) and torch.equal(p5, p4),
                      f"K5 {tab.name} {tag}: at K4's tolerance not bitwise "
                      "K4")
                zn5, p5 = rk_stage.rk_stage_combine_err_batched_rowtol(
                    *args, rt, at)
                zp, sqp = rk_stage.combine_err_batched_plain(*args, rt, at)
                torch.cuda.synchronize()
                diff = float((zn5.float() - zp.float()).abs().max())
                worst["rk_stage_combine_err_batched_rowtol"] = max(
                    worst["rk_stage_combine_err_batched_rowtol"], diff)
                check(torch.equal(zn5, zp),
                      f"K5 {tab.name} {tag}: z_next not bitwise equal "
                      f"(max |diff| {diff})")
                norms_close(p5, sqp, f"K5 {tab.name} {tag}")
            cases.append({"rows": B, "n": n,
                          "dtype": str(dtype).replace("torch.", ""),
                          "k3_rows": len(rows), "bitwise": True,
                          "frozen_row_bitwise": True,
                          "k5_equal_tol_is_k4": True})
    emit({"phase": "kernels_batched", "ok": True, "cases": cases,
          "max_abs_err": worst, "row_norm_rtol": ROW_NORM_RTOL})

    # times at the batched paths' shapes, f32: (8, 393,216) is the
    # batch_axis=0 block state, (8, 393,218) the serving state
    timings = {}
    for n in (ROW_N, SERVE_ROW_N):
        z = torch.randn(B, n, generator=gen, device="cuda")
        k = torch.randn(7, B, n, generator=gen, device="cuda")
        h = torch.linspace(0.01, 0.08, B, device="cuda")

        def k3_entry(label, a, rows_k):
            kk = k[:rows_k].contiguous()
            used = used_rows([a[:rows_k]])
            hw = (h[:, None] * torch.tensor(a[:rows_k], device="cuda"))[
                :, None]                                    # (B, 1, j)
            kt, zb = kk.permute(1, 0, 2), z[:, None]        # (B, j, n)
            timings[f"{label}_{n}"] = {
                "n": n,
                "ms": time_ms(torch, lambda: rk_stage.
                              rk_stage_increment_batched(z, kk, h, a)),
                "plain_ms": time_ms(torch, lambda: rk_stage.
                                    increment_batched_plain(z, kk, h, a)),
                "library_ms": time_ms(torch, lambda: torch.baddbmm(
                    zb, hw, kt)),
                "bytes": 4 * B * n * (len(used) + 2) + 4 * B,
                "flops": 2 * B * n * (len(used) + 1),
            }

        def comb_entry(label, tab, row_tol):
            kk = k[:tab.stages].contiguous()
            used = used_rows([tab.b, tab.b_err])
            tols = (rt, at) if row_tol else (1e-2, 1e-2)
            fn = rk_stage.rk_stage_combine_err_batched_rowtol if row_tol \
                else rk_stage.rk_stage_combine_err_batched
            timings[f"{label}_{n}"] = {
                "n": n,
                "ms": time_ms(torch, lambda: fn(z, kk, h, tab.b, tab.b_err,
                                                *tols)),
                "plain_ms": time_ms(torch, lambda: rk_stage.
                                    combine_err_batched_plain(
                                        z, kk, h, tab.b, tab.b_err, *tols)),
                "library_ms": None,
                "bytes": 4 * B * n * (len(used) + 2)
                + 4 * B * (3 if row_tol else 1),
                "flops": B * n * (4 * len(used) + 12),
            }

        k3_entry("k3_heun_stage", HEUN_EULER.a[1], 1)   # every trial
        k3_entry("k3_heun_b", HEUN_EULER.b, 2)          # ACA replay
        k3_entry("k3_dopri5_b", DOPRI5.b, 7)
        comb_entry("k4_heun", HEUN_EULER, False)
        comb_entry("k4_dopri5", DOPRI5, False)
        comb_entry("k5_heun", HEUN_EULER, True)
        comb_entry("k5_dopri5", DOPRI5, True)
    for t in timings.values():
        t["bound_ms"] = 1e3 * max(t["bytes"] / HBM_BYTES_PER_S,
                                  t["flops"] / F32_FLOP_PER_S)
        t["bound_by"] = ("bytes" if t["bytes"] / HBM_BYTES_PER_S
                         >= t["flops"] / F32_FLOP_PER_S else "operations")
        t["achieved_GBps"] = t["bytes"] / (t["ms"] * 1e-3) / 1e9
    emit({"phase": "kernel_times_batched", "ok": True, "rows": B,
          "dtype": "float32", "timings": timings})
    return worst, timings


def _parity_bound(res, req, ref_max: float) -> float:
    """The reference's chunked-serving parity bound (docs/serving.md)."""
    return (res.n_chunks + 1) * (req.atol + req.rtol * max(1.0, ref_max))


def phase_serve_node18(torch, seed: int):
    import numpy as np

    from repro_torch.configs import node18_cifar
    from repro_torch.core import odeint
    from repro_torch.kernels import rk_stage
    from repro_torch.models.config import RunConfig
    from repro_torch.models.transformer import TransformerBlock, branch_fn
    from repro_torch.serve import (
        NodeEngineConfig,
        NodeRequest,
        NodeServeEngine,
    )

    block = TransformerBlock(node18_cifar.CONFIG,
                             RunConfig(compute_dtype=torch.float32),
                             seed=seed, device="cuda")
    params = {n: p.detach() for n, p in block.named_parameters()}
    sample = (1,) + NODE18_SHAPE[1:]

    def field(t, z, p):
        # one request's flat (512*768,) state as a batch of one sample
        return branch_fn(block, p, z.reshape(sample)).reshape(-1)

    ecfg = NodeEngineConfig(slots=BATCH_ROWS, solver="heun_euler",
                            chunk_dt=0.5, max_steps=64, use_pallas=True)
    engine = NodeServeEngine(field, ROW_N, (params,), ecfg, device="cuda")
    rng = np.random.default_rng(seed + 2)
    arrivals = np.cumsum(rng.exponential(2.0, SERVE_REQUESTS))
    reqs = []
    for _ in range(SERVE_REQUESTS):
        tol = float(rng.choice([1e-2, 1e-3]))
        reqs.append(NodeRequest(
            z0=rng.standard_normal(ROW_N).astype(np.float32), t0=0.0,
            t1=float(rng.choice([0.5, 1.0])), rtol=tol, atol=tol))
    for i, req in enumerate(reqs):
        engine.submit(req, arrival=float(arrivals[i]))

    rounds = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rk_stage.reset_launches()              # the main path starts here
    t_start = time.perf_counter()
    while True:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        more = engine.step()
        torch.cuda.synchronize()
        if not more:
            break
        row = {"round": engine.round - 1, "live": engine.occupancy_log[-1],
               "max_trials": engine.trials_log[-1],
               "wall_ms": 1e3 * (time.perf_counter() - t0)}
        rounds.append(row)
        emit({"phase": "serve_round", **row})
    wall_s = time.perf_counter() - t_start
    launches = dict(rk_stage.launches)     # the main path ends here
    peak = torch.cuda.max_memory_allocated() / 1e9
    results = [engine.results[i] for i in sorted(engine.results)]
    check(len(results) == SERVE_REQUESTS,
          f"serve: {len(results)} of {SERVE_REQUESTS} requests delivered")
    check(all(launches[k] > 0 for k in SERVE_KERNELS),
          f"serve: the rounds did not launch K3 and K5: {launches}")

    per_req = []
    with torch.no_grad():
        for res, req in zip(results, reqs):
            ys, st = odeint(field, torch.from_numpy(req.z0).cuda(),
                            [0.0, req.t1], (params,), solver="heun_euler",
                            rtol=req.rtol, atol=req.atol, max_steps=256,
                            use_pallas=True)
            ref = ys[-1].cpu().numpy()
            err = float(np.abs(res.z_final - ref).max())
            bound = _parity_bound(res, req, float(np.abs(ref).max()))
            per_req.append({"id": res.req_id, "t1": req.t1, "tol": req.rtol,
                            "status": res.status, "ok": res.ok,
                            "n_chunks": res.n_chunks,
                            "n_trials": res.n_trials,
                            "latency_sim": res.latency,
                            "solo_n_trials": int(st.n_trials),
                            "parity_err": err, "parity_bound": bound})

    # QoS isolation: the request that shared its admission round with the
    # most rows, served again alone
    admitted = {rid: rd for rd, _, rid in engine.admission_log}
    victim = max(sorted(admitted),
                 key=lambda rid: engine.occupancy_log[admitted[rid]])
    rows_in_mix = engine.occupancy_log[admitted[victim]]
    mixed = engine.results[victim]
    engine.reset()
    engine.submit(reqs[victim], arrival=float(arrivals[victim]))
    alone = engine.run()[0]
    qos = {"request": victim, "rows_in_mix": rows_in_mix,
           "bitwise": bool(np.array_equal(alone.z_final, mixed.z_final)),
           "n_trials": [alone.n_trials, mixed.n_trials],
           "max_abs_diff": float(np.abs(alone.z_final
                                        - mixed.z_final).max())}
    emit({"phase": "serve_node18", "ok": True,
          "d_model": node18_cifar.CONFIG.d_model, "slots": ecfg.slots,
          "solver": ecfg.solver, "chunk_dt": ecfg.chunk_dt,
          "state_row": ROW_N + 2, "requests": per_req, "rounds": len(rounds),
          "wall_s": wall_s, "round_ms": [r["wall_ms"] for r in rounds],
          "launches": {k: launches[k] for k in launches if launches[k]},
          "peak_mem_GB": peak, "qos_isolation": qos})
    check(all(r["ok"] for r in per_req),
          f"serve: requests not OK: {[r for r in per_req if not r['ok']]}")
    far = [r for r in per_req if not r["parity_err"] <= r["parity_bound"]]
    check(not far, f"serve: beyond the parity bound: {far}")
    check(qos["bitwise"] and alone.n_trials == mixed.n_trials,
          f"serve: QoS isolation broken, alone vs mix: {qos}")
    return launches, rounds


def phase_node18_batched(torch, seed: int):
    import dataclasses

    from repro_torch.configs import node18_cifar
    from repro_torch.models.transformer import full_buffer
    ncfg = dataclasses.replace(full_buffer(node18_cifar.NODE_TRAIN),
                               batch_axis=0)
    return _node18_train(torch, seed, ncfg, 2, BATCHED_KERNELS,
                         "node18_batched")


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
        phase = "kernels_batched"
        worst_b, timings_b = phase_kernels_batched(torch, args.seed)
        phase = "serve_node18"
        serve_launches, _ = phase_serve_node18(torch, args.seed)
        phase = "node18_batched"
        batched_launches, _ = phase_node18_batched(torch, args.seed)
    except Exception as exc:
        emit({"phase": phase, "ok": False,
              "error": f"{type(exc).__name__}: {exc}"})
        raise

    # launches: K1/K2 from the node18 block steps, K3 from the serve rounds
    # and the batched block steps, K4 from the batched block steps, K5 from
    # the serve rounds; times at each path's shape (K3 and K5 at the
    # serving row, K4 at the batched block row)
    worst.update(worst_b)
    batch_launch = {
        "rk_stage_increment_batched":
        serve_launches["rk_stage_increment_batched"]
        + batched_launches["rk_stage_increment_batched"],
        "rk_stage_combine_err_batched":
        batched_launches["rk_stage_combine_err_batched"],
        "rk_stage_combine_err_batched_rowtol":
        serve_launches["rk_stage_combine_err_batched_rowtol"],
    }
    launches = {**{k: launches[k] for k in K1_K2}, **batch_launch}
    entries = [
        ("rk_stage_increment", "src/repro/kernels/rk_stage.py:209",
         timings["k1_heun_stage"]),
        ("rk_stage_combine_err", "src/repro/kernels/rk_stage.py:269",
         timings["k2_heun"]),
        ("rk_stage_increment_batched", "src/repro/kernels/rk_stage.py:357",
         timings_b[f"k3_heun_stage_{SERVE_ROW_N}"]),
        ("rk_stage_combine_err_batched",
         "src/repro/kernels/rk_stage.py:419",
         timings_b[f"k4_heun_{ROW_N}"]),
        ("rk_stage_combine_err_batched_rowtol",
         "src/repro/kernels/rk_stage.py:499",
         timings_b[f"k5_heun_{SERVE_ROW_N}"]),
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
