#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N]

Run from the repository root on a machine with a CUDA card. Phases, each
printing one JSON line (``"phase": ...``):

1. ``build``        — nvcc builds every kernel source of the port
                      (``src/repro_torch/kernels/csrc/*.cu``) into
                      ``build/repro_torch/``; build seconds and ptxas's
                      registers and spills per kernel.
2. ``kernels``      — K1, K2 and K6 against their plain PyTorch versions on
                      the card at N = 3,145,728 (the node18 block's state)
                      and N = 1,000,003 (a ragged tail), f32 and bf16:
                      z_next bitwise (K6's err too), K2's err and norm sum
                      within a relative tolerance; times by CUDA events
                      beside the byte bound. K6 is on no solver path: its
                      launches are this phase's own.
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
8. ``kernels_lm``   — K7 (RMSNorm), K8 (windowed GQA flash attention) and
                      K10 (RG-LRU scan) against their plain versions on the
                      card at the recurrentgemma_9b serving shapes: K7 at
                      (16384, 4096) and (16383, 4096), f32 and bf16, and
                      the decode shape (4, 4096); K8 at q (4, 16, 4096,
                      256), one kv head, window 2048 and 0, f32 and bf16,
                      and at S = 1000; K10 at (4, 4096, 4096) and (2,
                      1000, 4096). Times beside the bound, the plain
                      version and the library call (``F.rms_norm``,
                      ``F.scaled_dot_product_attention`` with the band
                      mask; none for K10); the launch floor (an empty
                      kernel on the same ctypes route, timed as every
                      kernel is); K7 also at the decode rows (4,
                      D) of D = 4096, 2560 and 5120, through the kernel
                      its rule picks and through each of its two kernels
                      (one-pass, two-pass); K8 also at window 0 beside
                      SDPA's causal call (``is_causal=True``).
9. ``serve_recurrentgemma`` — ``ServeEngine.generate`` over
                      ``build_model(recurrentgemma_9b.CONFIG with
                      n_layers=5)``: full width (d_model 4096, 16 heads, 1
                      kv head, head_dim 256, d_ff 12288, vocab 256000,
                      window 2048, d_rnn 4096), one (rec, rec, attn) group
                      and the 2-layer rec tail, bf16 params and compute,
                      ``use_pallas=True``, seeded random weights. Call A:
                      4 prompts of 4096 tokens, 32 new (greedy; decode
                      wraps the 2048-slot ring); call B: 2 prompts of 1000,
                      16 new. Launches checked exactly per call; then the
                      plain route on the same weights (last-position
                      logits, greedy tokens where the margin allows) and
                      one f32 prefill of both routes.
10. ``kernels_ssm``  — K9 (the Mamba-2 SSD chunk scan) against its plain
                      version (``ssd_chunked``) on the card at the
                      mamba2_2_7b prefill shapes: x (4, 4096, 80, 64) and
                      (2, 1024, 80, 64), one group of state 128, chunk 256,
                      bf16 and f32, y and h_last, at the reference init and
                      (4, 4096) again with weak decay, where the state
                      carried between chunks dominates; K9's three bf16
                      kernels (chunk states, state pass, chunk outputs)
                      one at a time against their plain parts at (4, 4096),
                      both decays; K7 at the Mamba-2 widths 5120 and 2560.
                      K9's time beside its operations bound and the plain
                      version (no library call computes it), and each of
                      its three kernels' times, their sum and the design's
                      byte floor (the bytes the three move, each kernel's
                      inputs read once and outputs written once).
11. ``serve_mamba2`` — ``ServeEngine.generate`` over
                      ``build_model(mamba2_2_7b.CONFIG)``: all 64 layers at
                      full width (d_model 2560, d_inner 5120, 80 heads x 64,
                      state 128, one group, conv 4, chunk 256, vocab
                      50,280), 2.83 B parameters, bf16, ``use_pallas=True``,
                      seeded random weights. Call A: 4 prompts of 4096
                      tokens, 32 new (greedy); call B: 2 prompts of 1000
                      (padded to 1024 inside the blocks), 16 new. Launches
                      checked exactly per call (K9, and each of its three
                      kernels, once per layer per prefill, K7 2 per layer +
                      1 per prefill and per decode step); peak memory and
                      prefill time per call; one prefill of call A and one
                      decode step
                      traced with torch.profiler (device busy and idle
                      share, device time by kernel class); then the plain
                      route on the same weights and one f32 prefill of
                      both routes on call B's prompts.
12. the ``kernels`` summary line (K1-K10, and K9's three kernels; each
   with the launch floor, K7 with its decode times and the launches of
   each of its two kernels over both LM paths, K8 with its window-0 time
   and SDPA's causal time), the card's name and power limit,
   and the last line ``{"ok": true, "device": {...}}``.

Each main path (node18_block for K1/K2, serve_node18 for K3/K5,
node18_batched for K3/K4, each serve_recurrentgemma call for K7/K8/K10,
each serve_mamba2 call for K7/K9) runs with every launch count set to 0
just before it and read just after.

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

BF16_FLOP_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
RG_LAYERS = 5                   # one (rec, rec, attn) group + 2 rec tail
RG_CALLS = {"A": (4, 4096, 32), "B": (2, 1000, 16)}  # prompts, length, new
LM_KERNELS = ("rmsnorm", "flash_attention", "rg_lru")

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
# K7 against torch's RMSNorm, as max |diff| / max |plain|: f32 sums the
# squares in another order and rsqrtf differs by an ulp or two; bf16 both
# round one f32 value, so one bf16 ulp of each value
RMS_F32_RTOL = 2e-6
RMS_BF16_ULPS = 1.0
# K8 against dense masked attention in f32: FMA sums in another order
# (f32); the kernel rounds p to bf16 for the tensor cores (bf16)
ATT_F32_RTOL = 2e-5
ATT_BF16_RTOL = 1e-2
# K10 against the doubling scan: products in another order
LRU_RTOL = 1e-5
# the served model, kernels vs plain route, as a share of max |logit|:
# bf16 activations round at every layer in other places (K8 keeps scores
# in f32 where the plain route rounds them to bf16), so the routes agree
# to a few bf16 ulps of the logits; in f32 only summation order differs.
# Two logits each within the tolerance can swap places only where their
# margin is under twice it: greedy tokens must agree wherever the plain
# route's top-2 margin exceeds 2 x LOGIT_BF16_RTOL x max |logit|
LOGIT_BF16_RTOL = 2e-2
LOGIT_F32_RTOL = 1e-3

# K9 against its plain version (ssd_chunked), as a share of max |plain|:
# f32 sums its products and the chunk cumsum in other orders; in bf16 both
# round one near-f32 value to bf16, so one bf16 ulp of each plain value on
# top of the f32 bound. h_last is f32 in both.
SSD_F32_RTOL = 1e-4
# the weak-decay K9 case is drawn so that a chunk keeps about e^-1 of its
# state; below this median the carried state would no longer dominate
SSD_WEAK_DECAY = 0.1
M2_CALLS = {"A": (4, 4096, 32), "B": (2, 1000, 16)}  # prompts, length, new
# K9's three bf16 kernels, each launched once per bf16 K9 call
K9_PARTS = ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_scan")
SSM_KERNELS = ("rmsnorm", "ssd_scan") + K9_PARTS
# the served Mamba-2, kernels vs plain route, as a share of max |logit|,
# derived before the first run: per layer the routes round the mixer's
# output differently by about one bf16 ulp (2^-8; K9 rounds y to bf16
# before the D-skip, the plain route after it; K7 and torch's RMSNorm may
# round a value to neighbouring bf16 numbers), independently from layer to
# layer, so over 64 layers the residual stream drifts by about sqrt(64) x
# 2^-8 = 3.1e-2 of its size; with a factor 1.6 for the head, 5e-2. Greedy
# tokens must agree wherever the plain route's top-2 margin exceeds
# 2 x M2_LOGIT_BF16_RTOL x max |logit|; the f32 prefill as LOGIT_F32_RTOL.
M2_LOGIT_BF16_RTOL = 5e-2

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

def time_ms(torch, fn, iters: int = 30, warmup: int = 5, prep=None) -> float:
    """Mean device time of ``fn`` by CUDA events around each launch.

    Before each launch the card first spins ~1 ms (so the host has
    enqueued all of ``fn`` before the start event runs: host overhead is
    not timed) and then writes 128 MB (so ``fn`` finds the 50 MB L2 cold,
    as a solve's field evaluation leaves it between two stage kernels).
    ``prep`` (for a kernel that works in place) runs before each launch,
    outside the timed span.
    """
    flush = torch.empty(32 * 1024 * 1024, dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        if prep is not None:
            prep()
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        if prep is not None:
            prep()
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
    worst = {"rk_stage_increment": 0.0, "rk_stage_combine_err": 0.0,
             "rk_stage_combine": 0.0}
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
            for tab in (HEUN_EULER, DOPRI5):
                kk = k[:tab.stages].contiguous()
                for e in (tab.b_err, None):
                    zn, err = rk_stage.rk_stage_combine(z, kk, h, tab.b, e)
                    zn_p, err_p = rk_stage.combine_plain(z, kk, h, tab.b, e)
                    torch.cuda.synchronize()
                    diff = max(float((zn.float() - zn_p.float()).abs().max()),
                               float((err - err_p).abs().max()))
                    worst["rk_stage_combine"] = max(
                        worst["rk_stage_combine"], diff)
                    check(torch.equal(zn, zn_p) and torch.equal(err, err_p),
                          f"K6 {tab.name} n={n} {dtype} e={e is not None}: "
                          f"not bitwise equal (max |diff| {diff})")
            cases.append({"n": n, "dtype": str(dtype).replace("torch.", ""),
                          "k1_rows": len(rows), "bitwise": True})
    # K6 is on no solver path: its launches are this phase's own
    k6_launches = rk_stage.launches["rk_stage_combine"]
    emit({"phase": "kernels", "ok": True, "cases": cases,
          "max_abs_err": worst, "err_rtol": ERR_RTOL,
          "norm_rtol": NORM_RTOL, "k6_launches": k6_launches})

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

    def k6_entry(label, tab):
        kk = k[:tab.stages].contiguous()
        used = used_rows([tab.b, tab.b_err])
        nbytes = 4 * n * (len(used) + 3) + 4
        flops = n * (4 * len(used) + 3)
        timings[label] = {
            "ms": time_ms(torch, lambda: rk_stage.rk_stage_combine(
                z, kk, h, tab.b, tab.b_err)),
            "plain_ms": time_ms(torch, lambda: rk_stage.combine_plain(
                z, kk, h, tab.b, tab.b_err)),
            "library_ms": None,
            "bytes": nbytes, "flops": flops,
        }

    k1_entry("k1_heun_stage", HEUN_EULER.a[1], 1)      # trial loop
    k1_entry("k1_heun_b", HEUN_EULER.b, 2)             # ACA replay
    k1_entry("k1_dopri5_b", DOPRI5.b, 7)
    k2_entry("k2_heun", HEUN_EULER, False)             # trial loop
    k2_entry("k2_dopri5", DOPRI5, False)
    k6_entry("k6_heun", HEUN_EULER)
    for t in timings.values():
        t["bound_ms"] = 1e3 * max(t["bytes"] / HBM_BYTES_PER_S,
                                  t["flops"] / F32_FLOP_PER_S)
        t["bound_by"] = ("bytes" if t["bytes"] / HBM_BYTES_PER_S
                         >= t["flops"] / F32_FLOP_PER_S else "operations")
        t["achieved_GBps"] = t["bytes"] / (t["ms"] * 1e-3) / 1e9
    emit({"phase": "kernel_times", "ok": True, "n": n, "dtype": "float32",
          "timings": timings})
    return worst, timings, k6_launches


def phase_toy_gradient(torch):
    from repro_torch.core import odeint
    from repro_torch.kernels import ops, rk_stage
    z0v = 1.5
    rows = []
    ops.reset_launches()
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
    from repro_torch.kernels import ops, rk_stage
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
    ops.reset_launches()                   # the main path starts here
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
    from repro_torch.kernels import ops, rk_stage
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
    ops.reset_launches()                   # the main path starts here
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


def _rel(a, b) -> float:
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp_min(1e-30))


def _bf16_ulps(torch, a, b) -> float:
    """max |a - b| in units of b's bf16 ulp (8 significant bits)."""
    a, b = a.float(), b.float()
    _, e = torch.frexp(b.abs())
    ulp = torch.ldexp(torch.ones_like(b), e - 8).clamp_min(2.0 ** -133)
    return float(((a - b).abs() / ulp).max())


def _band_pairs(s: int, window: int) -> int:
    """(query, key) pairs of causal attention over s positions, each query
    seeing min(q + 1, window) keys (window 0: all q + 1)."""
    if window <= 0 or window >= s:
        return s * (s + 1) // 2
    return window * (window + 1) // 2 + (s - window) * window


def _bound(t: dict) -> None:
    by_bytes = t["bytes"] / HBM_BYTES_PER_S
    by_ops = t["flops"] / t["peak_flops"]
    t["bound_ms"] = 1e3 * max(by_bytes, by_ops)
    t["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"


def phase_kernels_lm(torch, seed: int):
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rg_lru as lru
    from repro_torch.kernels import rmsnorm as k7
    from repro_torch.models.common import rmsnorm as rmsnorm_plain

    gen = torch.Generator(device="cuda").manual_seed(seed + 13)
    worst = {k: 0.0 for k in LM_KERNELS}
    cases = []

    def rnd(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device="cuda")

    for rows in (16384, 16383, 4):
        for dtype in (torch.bfloat16, torch.float32):
            if rows == 4 and dtype == torch.float32:
                continue
            x = rnd(rows, 4096, scale=3.0).to(dtype)
            w = rnd(4096).to(dtype)
            ref = rmsnorm_plain(x, w)
            # the kernel K7's rule picks, then each of its two kernels
            for kernel in (None,) + k7.KERNELS:
                out = k7.rmsnorm(x, w, kernel=kernel)
                torch.cuda.synchronize()
                diff = float((out.float() - ref.float()).abs().max())
                worst["rmsnorm"] = max(worst["rmsnorm"], diff)
                if dtype == torch.float32:
                    err = _rel(out, ref)
                    ok = err <= RMS_F32_RTOL
                else:
                    err = _bf16_ulps(torch, out, ref)
                    ok = err <= RMS_BF16_ULPS
                cases.append({"kernel": "rmsnorm", "shape": [rows, 4096],
                              "dtype": str(dtype)[6:],
                              "k7_kernel": kernel or "rule", "err": err,
                              "max_abs_err": diff})
                check(ok, f"K7 ({rows}, 4096) {dtype} {kernel or 'rule'}: "
                      f"{err} beyond tolerance")
    for b, s, window in ((4, 4096, 2048), (4, 4096, 0), (2, 1000, 2048)):
        for dtype in (torch.bfloat16, torch.float32):
            q = rnd(b, 16, s, 256).to(dtype)
            k = rnd(b, 1, s, 256).to(dtype)
            v = rnd(b, 1, s, 256).to(dtype)
            out = ops.flash_attention(q, k, v, window=window)
            ref = fa.flash_attention_plain(q, k, v, window=window)
            torch.cuda.synchronize()
            diff = float((out.float() - ref.float()).abs().max())
            worst["flash_attention"] = max(worst["flash_attention"], diff)
            err = _rel(out, ref)
            tol = ATT_F32_RTOL if dtype == torch.float32 else ATT_BF16_RTOL
            cases.append({"kernel": "flash_attention",
                          "shape": [b, 16, s, 256], "kv_heads": 1,
                          "window": window, "dtype": str(dtype)[6:],
                          "err": err, "max_abs_err": diff})
            check(bool(torch.isfinite(out).all()) and err <= tol,
                  f"K8 {(b, 16, s, 256)} window {window} {dtype}: {err} "
                  f"beyond {tol}")
            del q, k, v, out, ref
    for b, s in ((4, 4096), (2, 1000)):
        log_a = -F.softplus(rnd(b, s, 4096))
        x = rnd(b, s, 4096)
        out = ops.rg_lru(log_a, x)
        ref = lru.rg_lru_plain(log_a, x)
        torch.cuda.synchronize()
        diff = float((out - ref).abs().max())
        worst["rg_lru"] = max(worst["rg_lru"], diff)
        err = _rel(out, ref)
        cases.append({"kernel": "rg_lru", "shape": [b, s, 4096],
                      "dtype": "float32", "err": err, "max_abs_err": diff})
        check(err <= LRU_RTOL, f"K10 ({b}, {s}, 4096): {err} > {LRU_RTOL}")
    strong = ops.rg_lru(torch.full((1, 4096, 64), -2.0, device="cuda"),
                        torch.ones((1, 4096, 64), device="cuda"))
    fixed = 1.0 / (1.0 - math.exp(-2.0))
    check(bool(torch.isfinite(strong).all())
          and abs(float(strong[0, -1, 0]) - fixed) <= 1e-5 * fixed,
          "K10 strong decay: not the fixed point 1 / (1 - e^-2)")
    emit({"phase": "kernels_lm", "ok": True, "cases": cases,
          "max_abs_err": worst,
          "tolerances": {"rmsnorm_f32_rtol": RMS_F32_RTOL,
                         "rmsnorm_bf16_ulps": RMS_BF16_ULPS,
                         "attention_f32_rtol": ATT_F32_RTOL,
                         "attention_bf16_rtol": ATT_BF16_RTOL,
                         "rg_lru_rtol": LRU_RTOL}})

    # times at the serving path's shapes and types (prefill of call A; K7
    # also at the decode rows of both LMs' widths); K7 through the kernel
    # its rule picks ("ms") and through each of its two kernels
    timings = {}
    # the launch floor: an empty kernel of one warp on the kernels' ctypes
    # route, timed as every kernel is; no kernel can take less. Taken here,
    # beside K7's decode rows, with the card's clocks up
    timings["launch_floor"] = {"ms": time_ms(
        torch, lambda: k7.noop("cuda"), iters=50, warmup=10)}
    for key, rows, d in (("rmsnorm", 16384, 4096),
                         ("rmsnorm_decode", 4, 4096),
                         ("rmsnorm_decode_2560", 4, 2560),
                         ("rmsnorm_decode_5120", 4, 5120)):
        x = rnd(rows, d).to(torch.bfloat16)
        w = rnd(d).to(torch.bfloat16)
        timings[key] = {
            "shape": [rows, d], "dtype": "bfloat16",
            "kernel": k7.kernel_for(d, 2, True),
            "ms": time_ms(torch, lambda: ops.rmsnorm(x, w)),
            **{f"{k}_ms": time_ms(torch, lambda k=k: k7.rmsnorm(
                x, w, kernel=k)) for k in k7.KERNELS},
            "plain_ms": time_ms(torch, lambda: rmsnorm_plain(x, w)),
            "library_ms": time_ms(torch, lambda: F.rms_norm(
                x, (d,), w, 1e-6)),
            "bytes": 2 * rows * d * 2 + d * 2,
            "flops": 4 * rows * d, "peak_flops": F32_FLOP_PER_S}
    del x, w
    b, s, window = 4, 4096, 2048
    q = rnd(b, 16, s, 256).to(torch.bfloat16)
    k = rnd(b, 1, s, 256).to(torch.bfloat16)
    v = rnd(b, 1, s, 256).to(torch.bfloat16)
    ke = k.expand(b, 16, s, 256).contiguous()
    ve = v.expand(b, 16, s, 256).contiguous()
    mask = fa.band_mask(s, window, device="cuda")
    timings["flash_attention"] = {
        "shape": [b, 16, s, 256], "kv_heads": 1, "window": window,
        "dtype": "bfloat16",
        "ms": time_ms(torch, lambda: ops.flash_attention(
            q, k, v, window=window), iters=10, warmup=2),
        "plain_ms": time_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, window=window), iters=5, warmup=1),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, ke, ve, attn_mask=mask), iters=10, warmup=2),
        "bytes": 2 * (2 * q.numel() + k.numel() + v.numel()),
        "flops": 4 * 256 * b * 16 * _band_pairs(s, window),
        "peak_flops": BF16_FLOP_PER_S}
    # window 0 (causal) beside SDPA's own causal path, which computes K8's
    # function there without a mask tensor
    timings["flash_attention_causal"] = {
        "shape": [b, 16, s, 256], "kv_heads": 1, "window": 0,
        "dtype": "bfloat16",
        "ms": time_ms(torch, lambda: ops.flash_attention(
            q, k, v, window=0), iters=10, warmup=2),
        "plain_ms": time_ms(torch, lambda: fa.flash_attention_plain(
            q, k, v, window=0), iters=5, warmup=1),
        "library_ms": time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, ke, ve, is_causal=True), iters=10, warmup=2),
        "bytes": 2 * (2 * q.numel() + k.numel() + v.numel()),
        "flops": 4 * 256 * b * 16 * _band_pairs(s, 0),
        "peak_flops": BF16_FLOP_PER_S}
    del q, k, v, ke, ve
    log_a = -F.softplus(rnd(4, 4096, 4096))
    x = rnd(4, 4096, 4096)
    timings["rg_lru"] = {
        "shape": [4, 4096, 4096], "dtype": "float32",
        "ms": time_ms(torch, lambda: ops.rg_lru(log_a, x), iters=10,
                      warmup=2),
        "plain_ms": time_ms(torch, lambda: lru.rg_lru_plain(log_a, x),
                            iters=5, warmup=1),
        "library_ms": None,
        "bytes": 3 * log_a.numel() * 4,
        "flops": 3 * log_a.numel(), "peak_flops": F32_FLOP_PER_S}
    del log_a, x
    for key, t in timings.items():
        if key != "launch_floor":
            _bound(t)
    emit({"phase": "kernel_times_lm", "ok": True, "timings": timings})
    return worst, timings


def _cast_tree(tree, dtype):
    """Floating leaves to ``dtype``; RG-LRU's ``lam`` stays f32."""
    return {k: (_cast_tree(v, dtype) if isinstance(v, dict)
                else v if k == "lam" else v.to(dtype))
            for k, v in tree.items()}


def _margins(torch, model, params, toks, s, new):
    """The model's last-position logits along ``toks`` (B, s + new): the
    prefill's and each decode step's, teacher-forced; returns (top-2
    margins (B, new), max |logit|)."""
    margins, top = [], 0.0
    with torch.no_grad():
        lg, caches = model.prefill(params, {"tokens": toks[:, :s]})
        for j in range(new):
            top2 = torch.topk(lg.float(), 2, dim=-1).values
            margins.append(top2[:, 0] - top2[:, 1])
            top = max(top, float(lg.float().abs().max()))
            if j + 1 < new:
                lg, caches = model.decode_step(
                    params, {"tokens": toks[:, s + j:s + j + 1]}, caches,
                    s + j)
    return torch.stack(margins, dim=1), top


def phase_serve_recurrentgemma(torch, seed: int):
    import dataclasses

    from repro_torch.configs import recurrentgemma_9b
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as k7
    from repro_torch.models.config import RunConfig
    from repro_torch.models.lm import build_model
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = dataclasses.replace(recurrentgemma_9b.CONFIG, n_layers=RG_LAYERS)
    max_seq = max(s + n for _, s, n in RG_CALLS.values()) + 8
    run16 = RunConfig(compute_dtype=torch.bfloat16,
                      param_dtype=torch.bfloat16, use_pallas=True,
                      max_seq=max_seq)
    model = build_model(cfg, run16)
    params = model.init(seed=seed, device="cuda")
    torch.cuda.synchronize()
    n_params = model.n_params()
    tgen = torch.Generator(device="cuda").manual_seed(seed + 5)
    prompts = {name: torch.randint(0, cfg.vocab, (b, s), generator=tgen,
                                   device="cuda", dtype=torch.int32)
               for name, (b, s, _) in RG_CALLS.items()}
    # warm-up (cuBLAS handles, the kernels' first launch): not counted
    ServeEngine(model, params, ServeConfig(max_new_tokens=2)).generate(
        prompts["B"][:, :64])
    torch.cuda.synchronize()

    calls, outs, main_launches = {}, {}, {k: 0 for k in LM_KERNELS}
    for name, (b, s, new) in RG_CALLS.items():
        engine = ServeEngine(model, params, ServeConfig(max_new_tokens=new))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()               # the main path starts here
        t0 = time.perf_counter()
        out = engine.generate(prompts[name])["tokens"]
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        counts = ops.launch_counts()       # the main path ends here
        peak = torch.cuda.max_memory_allocated() / 1e9
        steps = engine.last_decode_steps
        want = {"rmsnorm": (2 * RG_LAYERS + 1) * (1 + steps),
                "flash_attention": 1, "rg_lru": 4}
        got = {k: counts[k] for k in LM_KERNELS}
        check(got == want, f"call {name}: launches {got} != {want}")
        k7_kernels = dict(k7.variant_launches)
        check(sum(k7_kernels.values()) == got["rmsnorm"],
              f"call {name}: K7's kernels {k7_kernels} != {got['rmsnorm']}")
        check(steps == new - 1, f"call {name}: {steps} decode steps")
        for k in LM_KERNELS:
            main_launches[k] += got[k]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.prefill(prompts[name])
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        outs[name] = out
        calls[name] = {
            "prompts": b, "prompt_len": s, "new_tokens": new,
            "decode_steps": steps, "launches": got,
            "rmsnorm_kernels": k7_kernels,
            "generate_ms": 1e3 * gen_s, "prefill_ms": 1e3 * prefill_s,
            "decode_ms_per_token": 1e3 * (gen_s - prefill_s) / steps,
            "tokens_per_s": b * new / gen_s, "peak_mem_GB": peak,
            "finite_tokens": bool(((out >= 0) & (out < cfg.vocab)).all()),
        }
        check(tuple(out.shape) == (b, s + new)
              and calls[name]["finite_tokens"]
              and torch.equal(out[:, :s], prompts[name]),
              f"call {name}: output tokens {tuple(out.shape)} malformed")
        emit({"phase": "serve_call", "call": name, **calls[name]})

    # the plain route (use_pallas=False) on the same weights
    plain = build_model(cfg, dataclasses.replace(run16, use_pallas=False))
    routes = {}
    for name, (b, s, new) in RG_CALLS.items():
        with torch.no_grad():
            lk, _ = model.prefill(params, {"tokens": prompts[name]})
            lp, _ = plain.prefill(params, {"tokens": prompts[name]})
        out_p = ServeEngine(plain, params, ServeConfig(
            max_new_tokens=new)).generate(prompts[name])["tokens"]
        margins, top = _margins(torch, plain, params, out_p, s, new)
        tol = 2 * LOGIT_BF16_RTOL * top
        gen_k, gen_p = outs[name][:, s:], out_p[:, s:]
        equal, bad = 0, []
        for row in range(b):
            diff = (gen_k[row] != gen_p[row]).nonzero()
            first = int(diff[0]) if len(diff) else new
            equal += int((gen_k[row] == gen_p[row]).sum())
            if first < new and float(margins[row, first]) > tol:
                bad.append({"row": row, "step": first,
                            "margin": float(margins[row, first])})
        logit_err = _rel(lk, lp)
        routes[name] = {"prefill_logit_rel": logit_err,
                        "tokens_equal": equal, "tokens": b * new,
                        "max_logit": top, "margin_tol": tol,
                        "diverged_above_margin": bad}
        check(logit_err <= LOGIT_BF16_RTOL,
              f"call {name}: prefill logits kernels vs plain {logit_err} > "
              f"{LOGIT_BF16_RTOL}")
        check(not bad, f"call {name}: greedy tokens differ where the plain "
              f"route's margin exceeds the tolerance: {bad}")
    del params, model, plain
    torch.cuda.empty_cache()

    # one f32 prefill of both routes (TF32 off), the same seed's weights
    b, s, _ = RG_CALLS["A"]
    run32 = dataclasses.replace(run16, compute_dtype=torch.float32,
                                param_dtype=torch.float32)
    m32 = build_model(cfg, run32)
    p32 = m32.init(seed=seed, device="cuda")
    toks = prompts["A"][:1]
    with torch.no_grad():
        lk, _ = m32.prefill(p32, {"tokens": toks})
        lp, _ = build_model(cfg, dataclasses.replace(
            run32, use_pallas=False)).prefill(p32, {"tokens": toks})
    f32_err = _rel(lk, lp)
    del p32, m32
    torch.cuda.empty_cache()
    emit({"phase": "serve_recurrentgemma", "ok": True,
          "config": {"d_model": cfg.d_model, "n_layers": cfg.n_layers,
                     "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
                     "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
                     "vocab": cfg.vocab, "window": cfg.window,
                     "d_rnn": cfg.d_rnn, "n_params": n_params,
                     "dtype": "bfloat16", "max_seq": max_seq},
          "calls": calls, "kernels_vs_plain": routes,
          "logit_bf16_rtol": LOGIT_BF16_RTOL,
          "f32_prefill": {"prompts": 1, "prompt_len": s,
                          "logit_rel": f32_err,
                          "rtol": LOGIT_F32_RTOL},
          "launches": main_launches})
    check(f32_err <= LOGIT_F32_RTOL,
          f"f32 prefill kernels vs plain {f32_err} > {LOGIT_F32_RTOL}")
    return main_launches, calls


def _ssd_err(torch, y, yp) -> float:
    """max |y - yp| beyond one bf16 ulp of yp (bf16) or at all (f32),
    over max |yp|."""
    d = (y.float() - yp.float()).abs()
    if y.dtype == torch.bfloat16:
        _, e = torch.frexp(yp.float().abs())
        d = (d - torch.ldexp(torch.ones_like(d), e - 8)).clamp_min(0.0)
    return float(d.max() / yp.float().abs().max())


def _ssd_inputs(torch, gen, b, s, h, p, g, n, dtype, weak=False):
    """The Mamba-2 block's distributions at the reference init: x, B, C
    after SiLU-like scales, dt = softplus(N(0, 1)), a = -U[1, 16] (the
    uniform_ssm init). There a chunk of 256 steps decays by about e^-200,
    so the state carried between chunks adds nothing measurable. ``weak``
    draws long memory instead: dt log-uniform in [1e-3, 1e-2] (the low end
    of Mamba-2's dt init) and a = -exp(N(0, 1)) (the reference test's),
    so a chunk decays by about e^-1 and the carried state dominates y and
    h_last."""
    import math

    import torch.nn.functional as F
    x = (0.5 * torch.randn(b, s, h, p, generator=gen, device="cuda")).to(dtype)
    if weak:
        lo, hi = math.log(1e-3), math.log(1e-2)
        dt = torch.exp(lo + (hi - lo) * torch.rand(b, s, h, generator=gen,
                                                   device="cuda"))
        a = -torch.exp(torch.randn(h, generator=gen, device="cuda"))
    else:
        dt = F.softplus(torch.randn(b, s, h, generator=gen, device="cuda"))
        a = -(1.0 + 15.0 * torch.rand(h, generator=gen, device="cuda"))
    bm = (0.5 * torch.randn(b, s, g, n, generator=gen, device="cuda")).to(
        dtype)
    cm = (0.5 * torch.randn(b, s, g, n, generator=gen, device="cuda")).to(
        dtype)
    return x, dt, a, bm, cm


def phase_kernels_ssm(torch, seed: int):
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as k7
    from repro_torch.kernels import ssd_scan as k9
    from repro_torch.models.common import rmsnorm as rmsnorm_plain

    gen = torch.Generator(device="cuda").manual_seed(seed + 17)
    worst = {"ssd_scan": 0.0}
    cases = []
    # K9 at the mamba2_2_7b prefill shapes: 80 heads x 64, one group of
    # state 128, chunk 256; call A's (4, 4096) and call B's padded (2, 1024)
    # at the reference init, and call A's with weak decay, where the state
    # carried over 16 chunks dominates (the median chunk decay exp(sum of
    # dt a over the chunk) is reported and must exceed SSD_WEAK_DECAY)
    for b, s, weak in ((4, 4096, False), (2, 1024, False), (4, 4096, True)):
        for dtype in (torch.bfloat16, torch.float32):
            x, dt, a, bm, cm = _ssd_inputs(torch, gen, b, s, 80, 64, 1, 128,
                                           dtype, weak=weak)
            decay = float(torch.exp((dt * a).reshape(b, s // 256, 256, 80)
                                    .sum(2)).median())
            if weak:
                check(decay >= SSD_WEAK_DECAY,
                      f"K9 weak-decay inputs: median chunk decay {decay} "
                      f"< {SSD_WEAK_DECAY}")
            y, hl = ops.ssd_scan(x, dt, a, bm, cm, 256)
            yp, hp = k9.ssd_scan_plain(x, dt, a, bm, cm, 256)
            torch.cuda.synchronize()
            diff = float((y.float() - yp.float()).abs().max())
            worst["ssd_scan"] = max(worst["ssd_scan"], diff)
            err_y, err_h = _ssd_err(torch, y, yp), _rel(hl, hp)
            cases.append({"kernel": "ssd_scan", "shape": [b, s, 80, 64],
                          "state": 128, "groups": 1, "chunk": 256,
                          "dtype": str(dtype)[6:],
                          "decay": "weak" if weak else "reference init",
                          "median_chunk_decay": decay, "y_err": err_y,
                          "h_last_rel": err_h, "max_abs_err": diff})
            check(bool(torch.isfinite(y.float()).all())
                  and err_y <= SSD_F32_RTOL and err_h <= SSD_F32_RTOL,
                  f"K9 ({b}, {s}, 80, 64) {dtype} weak={weak}: y {err_y}, "
                  f"h_last {err_h} beyond {SSD_F32_RTOL}")
            del x, dt, a, bm, cm, y, hl, yp, hp
            torch.cuda.empty_cache()
    # K9's three bf16 kernels one at a time against their plain parts, on
    # the same inputs, at call A's shape (reference init and weak decay):
    # cs and S_c (chunk_states), h_prev and h_last (state_pass) as a share
    # of max |plain|, y (chunk_outputs) beyond one bf16 ulp
    for k in K9_PARTS:
        worst[k] = 0.0
    for weak in (False, True):
        x, dt, a, bm, cm = _ssd_inputs(torch, gen, 4, 4096, 80, 64, 1, 128,
                                       torch.bfloat16, weak=weak)
        cs_p, st_p = k9.chunk_states(x, dt, a, bm, 256)
        hp_p, hl_p = k9.state_pass(st_p, cs_p, 256)
        cs, st = k9.ssd_chunk_state(x, dt, a, bm, 256)
        got = {"ssd_chunk_state": ((cs, cs_p), (st, st_p))}
        hp, hl = k9.ssd_state_pass(st_p.clone(), cs_p, 256)
        got["ssd_state_pass"] = ((hp, hp_p), (hl, hl_p))
        y = k9.ssd_chunk_scan(x, dt, cs_p, bm, cm, hp_p, 256)
        got["ssd_chunk_scan"] = ((y, k9.chunk_outputs(
            x, dt, cs_p, bm, cm, hp_p, 256).to(x.dtype)),)
        torch.cuda.synchronize()
        for k, pairs in got.items():
            err = max(_ssd_err(torch, u, v) if u.dtype == torch.bfloat16
                      else _rel(u, v) for u, v in pairs)
            diff = max(float((u.float() - v.float()).abs().max())
                       for u, v in pairs)
            worst[k] = max(worst[k], diff)
            cases.append({"kernel": k, "shape": [4, 4096, 80, 64],
                          "state": 128, "groups": 1, "chunk": 256,
                          "dtype": "bfloat16",
                          "decay": "weak" if weak else "reference init",
                          "err": err, "max_abs_err": diff})
            check(err <= SSD_F32_RTOL and all(
                bool(torch.isfinite(u.float()).all()) for u, _ in pairs),
                f"{k} (4, 4096, 80, 64) weak={weak}: {err} beyond "
                f"{SSD_F32_RTOL}")
        del x, dt, a, bm, cm, cs_p, st_p, hp_p, hl_p, cs, st, hp, hl, y, got
        torch.cuda.empty_cache()
    # K7 at the Mamba-2 widths: the gated norm (5120) and the final norm
    # (2560), call A's prefill rows and the decode rows
    for d in (5120, 2560):
        for rows, dtype in ((16384, torch.bfloat16), (16384, torch.float32),
                            (4, torch.bfloat16)):
            x = (3.0 * torch.randn(rows, d, generator=gen, device="cuda")).to(
                dtype)
            w = torch.randn(d, generator=gen, device="cuda").to(dtype)
            ref = rmsnorm_plain(x, w)
            # the kernel K7's rule picks, then each of its two kernels
            for kernel in (None,) + k7.KERNELS:
                out = k7.rmsnorm(x, w, kernel=kernel)
                torch.cuda.synchronize()
                if dtype == torch.float32:
                    err = _rel(out, ref)
                    ok = err <= RMS_F32_RTOL
                else:
                    err = _bf16_ulps(torch, out, ref)
                    ok = err <= RMS_BF16_ULPS
                cases.append({"kernel": "rmsnorm", "shape": [rows, d],
                              "dtype": str(dtype)[6:],
                              "k7_kernel": kernel or "rule", "err": err})
                check(ok, f"K7 ({rows}, {d}) {dtype} {kernel or 'rule'}: "
                      f"{err} beyond tolerance")
    emit({"phase": "kernels_ssm", "ok": True, "cases": cases,
          "max_abs_err": worst, "ssd_f32_rtol": SSD_F32_RTOL})

    # times at call A's prefill shape and type
    b, s, h, p, n, q = 4, 4096, 80, 64, 128, 256
    x, dt, a, bm, cm = _ssd_inputs(torch, gen, b, s, h, p, 1, n,
                                   torch.bfloat16)
    tiles = b * h * (s // q)
    timings = {"ssd_scan": {
        "shape": [b, s, h, p], "state": n, "chunk": q, "dtype": "bfloat16",
        "ms": time_ms(torch, lambda: ops.ssd_scan(x, dt, a, bm, cm, q),
                      iters=10, warmup=2),
        "plain_ms": time_ms(torch, lambda: k9.ssd_scan_plain(
            x, dt, a, bm, cm, q), iters=3, warmup=1),
        "library_ms": None,
        # x and y bf16, dt f32, B and C bf16, a, h_last f32
        "bytes": 2 * x.numel() * 2 + dt.numel() * 4 + 2 * bm.numel() * 2
        + h * 4 + b * h * p * n * 4,
        # the causal half of C B^T (Q (Q + 1) / 2 products of 2N flops),
        # its masked product with x (of 2P), C h and the state update
        "flops": tiles * (q * (q + 1) * n + q * (q + 1) * p
                          + 4 * q * n * p),
        "peak_flops": BF16_FLOP_PER_S}}
    # the three kernels alone, each on the outputs of the one before it;
    # bytes each reads and writes once, and their sum: the design's floor
    nc, st_n = s // q, b * (s // q) * h * p * n
    cs, st = k9.ssd_chunk_state(x, dt, a, bm, q)
    saved = st.clone()
    k9.ssd_state_pass(st, cs, q)
    h_prev = st.clone()
    timings["ssd_chunk_state"] = {
        "ms": time_ms(torch, lambda: k9.ssd_chunk_state(x, dt, a, bm, q),
                      iters=10, warmup=2),
        "plain_ms": time_ms(torch, lambda: k9.chunk_states(
            x, dt, a, bm, q), iters=3, warmup=1),
        # x, B, dt, a in; cs and S_c out
        "bytes": x.numel() * 2 + bm.numel() * 2 + dt.numel() * 4 + h * 4
        + dt.numel() * 4 + st_n * 4,
        "flops": tiles * 2 * q * n * p, "peak_flops": BF16_FLOP_PER_S}
    timings["ssd_state_pass"] = {
        "ms": time_ms(torch, lambda: k9.ssd_state_pass(st, cs, q),
                      iters=10, warmup=2, prep=lambda: st.copy_(saved)),
        "plain_ms": time_ms(torch, lambda: k9.state_pass(saved, cs, q),
                            iters=3, warmup=1),
        # S_c in, h_prev out, the chunks' last cs, h_last
        "bytes": 2 * st_n * 4 + b * nc * h * 4 + b * h * p * n * 4,
        "flops": 2 * st_n, "peak_flops": F32_FLOP_PER_S}
    timings["ssd_chunk_scan"] = {
        "ms": time_ms(torch, lambda: k9.ssd_chunk_scan(
            x, dt, cs, bm, cm, h_prev, q), iters=10, warmup=2),
        "plain_ms": time_ms(torch, lambda: k9.chunk_outputs(
            x, dt, cs, bm, cm, h_prev, q), iters=3, warmup=1),
        # x, dt, cs, B, C, h_prev in; y out
        "bytes": 2 * x.numel() * 2 + 2 * dt.numel() * 4
        + 2 * bm.numel() * 2 + st_n * 4,
        "flops": tiles * (q * (q + 1) * n + q * (q + 1) * p
                          + 2 * q * n * p),
        "peak_flops": BF16_FLOP_PER_S}
    for k in K9_PARTS:
        timings[k].update({"shape": [b, s, h, p], "state": n, "chunk": q,
                           "dtype": "bfloat16", "library_ms": None})
    del x, dt, a, bm, cm, cs, st, saved, h_prev
    xr = torch.randn(16384, 5120, generator=gen, device="cuda").to(
        torch.bfloat16)
    w = torch.randn(5120, generator=gen, device="cuda").to(torch.bfloat16)
    timings["rmsnorm_5120"] = {
        "shape": [16384, 5120], "dtype": "bfloat16",
        "ms": time_ms(torch, lambda: ops.rmsnorm(xr, w)),
        "plain_ms": time_ms(torch, lambda: rmsnorm_plain(xr, w)),
        "library_ms": time_ms(torch, lambda: F.rms_norm(
            xr, (5120,), w, 1e-6)),
        "bytes": 2 * xr.numel() * 2 + 5120 * 2,
        "flops": 4 * xr.numel(), "peak_flops": F32_FLOP_PER_S}
    del xr
    torch.cuda.empty_cache()
    for t in timings.values():
        _bound(t)
    k9t = timings["ssd_scan"]
    k9t["parts_ms"] = sum(timings[k]["ms"] for k in K9_PARTS)
    k9t["design_bytes"] = sum(timings[k]["bytes"] for k in K9_PARTS)
    k9t["design_floor_ms"] = 1e3 * k9t["design_bytes"] / HBM_BYTES_PER_S
    emit({"phase": "kernel_times_ssm", "ok": True, "timings": timings})
    return worst, timings


def _kernel_class(name: str) -> str:
    n = name.lower()
    if "ssd_scan" in n or any(k in n for k in K9_PARTS):
        return "ssd_scan"
    if "rmsnorm" in n:
        return "rmsnorm"
    # cuBLAS's Hopper GEMMs are named nvjet_*, older ones *gemm*/*xmma*
    if any(k in n for k in ("nvjet", "gemm", "xmma", "cutlass", "gemv")):
        return "matmul"
    return "other"


def _trace(torch, fn) -> dict:
    """One call of ``fn`` (after one untraced warm-up call) under
    torch.profiler: wall ms on the host clock to a synchronize, the
    device's busy ms (the sum of its kernels' times), kernels launched,
    the idle share 1 - busy / wall, device ms by class (matmul, K9, K7,
    other) and the six kernels with the most device time. The profiler
    adds host time per op, so the wall here is above an untraced one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name, by_class = {}, {}
    for e in kern:
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        cls = _kernel_class(e.name)
        by_class[cls] = by_class.get(cls, 0.0) + us
    busy_ms = 1e-3 * sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "kernels": len(kern),
            "idle_share": (1.0 - busy_ms / wall_ms) if kern else None,
            "device_ms_by_class": {k: 1e-3 * v for k, v in by_class.items()},
            "top": [[name[:80], 1e-3 * us] for name, us in top]}


def phase_serve_mamba2(torch, seed: int):
    import dataclasses

    from repro_torch.configs import mamba2_2_7b
    from repro_torch.kernels import ops
    from repro_torch.kernels import rmsnorm as k7
    from repro_torch.models.config import RunConfig
    from repro_torch.models.lm import build_model
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = mamba2_2_7b.CONFIG
    layers = cfg.n_layers
    run16 = RunConfig(compute_dtype=torch.bfloat16,
                      param_dtype=torch.bfloat16, use_pallas=True)
    model = build_model(cfg, run16)
    params = model.init(seed=seed, device="cuda")
    torch.cuda.synchronize()
    n_params = model.n_params()
    tgen = torch.Generator(device="cuda").manual_seed(seed + 7)
    prompts = {name: torch.randint(0, cfg.vocab, (b, s), generator=tgen,
                                   device="cuda", dtype=torch.int32)
               for name, (b, s, _) in M2_CALLS.items()}
    # warm-up (cuBLAS handles, the kernels' first launch): not counted
    ServeEngine(model, params, ServeConfig(max_new_tokens=2)).generate(
        prompts["B"][:, :64])
    torch.cuda.synchronize()

    calls, outs, main_launches = {}, {}, {k: 0 for k in SSM_KERNELS}
    for name, (b, s, new) in M2_CALLS.items():
        engine = ServeEngine(model, params, ServeConfig(max_new_tokens=new))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()               # the main path starts here
        t0 = time.perf_counter()
        out = engine.generate(prompts[name])["tokens"]
        torch.cuda.synchronize()
        gen_s = time.perf_counter() - t0
        counts = ops.launch_counts()       # the main path ends here
        peak = torch.cuda.max_memory_allocated() / 1e9
        steps = engine.last_decode_steps
        want = {"rmsnorm": (2 * layers + 1) * (1 + steps),
                "ssd_scan": layers, **{k: layers for k in K9_PARTS}}
        got = {k: counts[k] for k in SSM_KERNELS}
        others = {k: v for k, v in counts.items()
                  if k not in SSM_KERNELS and v}
        check(got == want and not others,
              f"call {name}: launches {got} (others {others}) != {want}")
        k7_kernels = dict(k7.variant_launches)
        check(sum(k7_kernels.values()) == got["rmsnorm"],
              f"call {name}: K7's kernels {k7_kernels} != {got['rmsnorm']}")
        check(steps == new - 1, f"call {name}: {steps} decode steps")
        for k in SSM_KERNELS:
            main_launches[k] += got[k]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.prefill(prompts[name])
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        outs[name] = out
        calls[name] = {
            "prompts": b, "prompt_len": s, "new_tokens": new,
            "decode_steps": steps, "launches": got,
            "rmsnorm_kernels": k7_kernels,
            "generate_ms": 1e3 * gen_s, "prefill_ms": 1e3 * prefill_s,
            "decode_ms_per_token": 1e3 * (gen_s - prefill_s) / steps,
            "tokens_per_s": b * new / gen_s, "peak_mem_GB": peak,
            "finite_tokens": bool(((out >= 0) & (out < cfg.vocab)).all()),
        }
        check(tuple(out.shape) == (b, s + new)
              and calls[name]["finite_tokens"]
              and torch.equal(out[:, :s], prompts[name]),
              f"call {name}: output tokens {tuple(out.shape)} malformed")
        emit({"phase": "serve_call", "model": "mamba2_2_7b", "call": name,
              **calls[name]})

    # where the time goes: one traced prefill of call A and one traced
    # decode step after call B's prefill (not main-path runs)
    with torch.no_grad():
        _, caches = model.prefill(params, {"tokens": prompts["B"]})
        nxt = outs["B"][:, M2_CALLS["B"][1]:M2_CALLS["B"][1] + 1]
        traces = {
            "prefill_A": _trace(torch, lambda: model.prefill(
                params, {"tokens": prompts["A"]})),
            "decode_step_B": _trace(torch, lambda: model.decode_step(
                params, {"tokens": nxt}, caches, M2_CALLS["B"][1])),
        }
    del caches
    emit({"phase": "serve_mamba2_trace", "traces": traces})

    # the plain route (use_pallas=False) on the same weights
    plain = build_model(cfg, dataclasses.replace(run16, use_pallas=False))
    routes = {}
    for name, (b, s, new) in M2_CALLS.items():
        with torch.no_grad():
            lk, _ = model.prefill(params, {"tokens": prompts[name]})
            lp, _ = plain.prefill(params, {"tokens": prompts[name]})
        check(bool(torch.isfinite(lk.float()).all()),
              f"call {name}: prefill logits not finite")
        out_p = ServeEngine(plain, params, ServeConfig(
            max_new_tokens=new)).generate(prompts[name])["tokens"]
        margins, top = _margins(torch, plain, params, out_p, s, new)
        tol = 2 * M2_LOGIT_BF16_RTOL * top
        gen_k, gen_p = outs[name][:, s:], out_p[:, s:]
        equal, bad = 0, []
        for row in range(b):
            diff = (gen_k[row] != gen_p[row]).nonzero()
            first = int(diff[0]) if len(diff) else new
            equal += int((gen_k[row] == gen_p[row]).sum())
            if first < new and float(margins[row, first]) > tol:
                bad.append({"row": row, "step": first,
                            "margin": float(margins[row, first])})
        logit_err = _rel(lk, lp)
        routes[name] = {"prefill_logit_rel": logit_err,
                        "tokens_equal": equal, "tokens": b * new,
                        "max_logit": top, "margin_tol": tol,
                        "margins_above_tol": int((margins > tol).sum()),
                        "diverged_above_margin": bad,
                        "share_of_bound": logit_err / M2_LOGIT_BF16_RTOL}
        check(logit_err <= M2_LOGIT_BF16_RTOL,
              f"call {name}: prefill logits kernels vs plain {logit_err} > "
              f"{M2_LOGIT_BF16_RTOL}")
        check(not bad, f"call {name}: greedy tokens differ where the plain "
              f"route's margin exceeds the tolerance: {bad}")
    del params, model, plain
    torch.cuda.empty_cache()

    # one f32 prefill of both routes on call B's prompts (TF32 off)
    run32 = dataclasses.replace(run16, compute_dtype=torch.float32,
                                param_dtype=torch.float32)
    m32 = build_model(cfg, run32)
    p32 = m32.init(seed=seed, device="cuda")
    ops.reset_launches()
    with torch.no_grad():
        lk, _ = m32.prefill(p32, {"tokens": prompts["B"]})
        f32_launches = ops.launch_counts()["ssd_scan"]
        lp, _ = build_model(cfg, dataclasses.replace(
            run32, use_pallas=False)).prefill(p32, {"tokens": prompts["B"]})
    f32_err = _rel(lk, lp)
    del p32, m32
    torch.cuda.empty_cache()
    emit({"phase": "serve_mamba2", "ok": True,
          "config": {"d_model": cfg.d_model, "n_layers": layers,
                     "d_inner": cfg.d_inner, "ssm_heads": cfg.ssm_heads,
                     "ssm_head_dim": cfg.ssm_head_dim,
                     "ssm_state": cfg.ssm_state,
                     "ssm_ngroups": cfg.ssm_ngroups,
                     "ssm_conv": cfg.ssm_conv, "ssm_chunk": cfg.ssm_chunk,
                     "vocab": cfg.vocab, "n_params": n_params,
                     "dtype": "bfloat16"},
          "calls": calls, "kernels_vs_plain": routes,
          "logit_bf16_rtol": M2_LOGIT_BF16_RTOL,
          "f32_prefill": {"prompts": M2_CALLS["B"][0],
                          "prompt_len": M2_CALLS["B"][1],
                          "logit_rel": f32_err, "rtol": LOGIT_F32_RTOL,
                          "ssd_scan_launches": f32_launches},
          "launches": main_launches})
    check(f32_launches == layers,
          f"f32 prefill: {f32_launches} K9 launches != {layers}")
    check(f32_err <= LOGIT_F32_RTOL,
          f"f32 prefill kernels vs plain {f32_err} > {LOGIT_F32_RTOL}")
    return main_launches, calls


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
        worst, timings, k6_launches = phase_kernels(torch, args.seed)
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
        phase = "kernels_lm"
        worst_lm, timings_lm = phase_kernels_lm(torch, args.seed)
        phase = "serve_recurrentgemma"
        lm_launches, lm_calls = phase_serve_recurrentgemma(torch, args.seed)
        phase = "kernels_ssm"
        worst_ssm, timings_ssm = phase_kernels_ssm(torch, args.seed)
        phase = "serve_mamba2"
        ssm_launches, ssm_calls = phase_serve_mamba2(torch, args.seed)
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
    launches = {**{k: launches[k] for k in K1_K2}, **batch_launch,
                "rk_stage_combine": k6_launches}
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
        ("rk_stage_combine", "src/repro/kernels/rk_stage.py:151",
         timings["k6_heun"]),
    ]
    entries = [(name, "rk_stage", replaces, t)
               for name, replaces, t in entries]
    worst.update(worst_lm)
    worst.update(worst_ssm)
    # K7 runs on both LM paths: its launches add up
    launches.update(lm_launches)
    launches["rmsnorm"] += ssm_launches["rmsnorm"]
    for k in ("ssd_scan",) + K9_PARTS:
        launches[k] = ssm_launches[k]
    k7_variants = {}
    for c in (*lm_calls.values(), *ssm_calls.values()):
        for k, n in c["rmsnorm_kernels"].items():
            k7_variants[k] = k7_variants.get(k, 0) + n
    entries += [
        ("rmsnorm", "rmsnorm", "src/repro/kernels/rmsnorm.py:27",
         timings_lm["rmsnorm"]),
        ("flash_attention", "flash_attention",
         "src/repro/kernels/flash_attention.py:94",
         timings_lm["flash_attention"]),
        ("ssd_scan", "ssd_scan", "src/repro/kernels/ssd_scan.py:84",
         timings_ssm["ssd_scan"]),
        *((k, "ssd_scan", "src/repro/kernels/ssd_scan.py:84", timings_ssm[k])
          for k in K9_PARTS),
        ("rg_lru", "rg_lru", "src/repro/kernels/rg_lru.py:52",
         timings_lm["rg_lru"]),
    ]
    # K7's decode rows and the launches of each of its two kernels, K8 at
    # window 0 beside SDPA's causal call
    extras = {
        "rmsnorm": {
            "kernel_launches": k7_variants,
            "decode_ms": {str(timings_lm[k]["shape"][1]): timings_lm[k]["ms"]
                          for k in ("rmsnorm_decode", "rmsnorm_decode_2560",
                                    "rmsnorm_decode_5120")}},
        "flash_attention": {
            "causal_ms": timings_lm["flash_attention_causal"]["ms"],
            "causal_library_ms":
            timings_lm["flash_attention_causal"]["library_ms"]},
    }
    emit({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{src}.cu",
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": worst[name], "ms": t["ms"],
         "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
         "bound_by": t["bound_by"], "library_ms": t["library_ms"],
         # no kernel takes less than one launch (an empty kernel's time)
         "launch_floor_ms": timings_lm["launch_floor"]["ms"],
         # K6 is on no path: its launches are the kernels phase's own
         "main_path": name != "rk_stage_combine",
         **extras.get(name, {})}
        for name, src, replaces, t in entries]})
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
