"""The solve-health guards' cost gate, on the port.

    PYTHONPATH=src python -m repro_torch.benchmarks.failure_overhead \\
        [--full] [--device cuda|cpu]

Port of ``benchmarks/bench_failure_overhead.py``, with its problem, rows
and gate. The non-finite guard runs inside every adaptive trial loop: one
finiteness test of the error ratio a trial (a non-finite trial state
always poisons it). This prices it on the stiff van der Pol loop (μ = 8,
a (2, 256) ensemble state, Dopri5 at rtol = atol = 1e-9, max_steps
65,536, eval times over [0, 40] quick and [0, 120] full) with
``adaptive_while_solve`` at ``guard_nonfinite=True`` and ``False``, and
gates the overhead at 5% of the bare solve; both must take the same
trials. As in the reference, ``reps`` back-to-back pairs (20 quick, 50
full) time the two solves and each is priced by its minimum time
(``guarded_s``, ``bare_s``), and the gate is skipped below a 1 ms bare
solve, under the noise floor.

The port's solve is an eager host loop (about 1.5 ms a trial on an
H100's host), and on a card whose host is shared the difference of whole
solves does not resolve 5%: single solves took 4.2 to 7.7 s within one
run, and on unchanged code, in one call, the minimum of 20 pairs read
+9.9% in one run and -2.3% in another (the minimum of each interval
between field evaluations, +8.7% and +0.6%). So the port prices the
guard by its parts. The guard flag acts in two places only:
``integrate.trial_decision``, once a trial, and the initial
``nonfinite_any`` check, once a solve. The benchmark first proves that
by counting tensor operations: a guarded solve dispatches exactly
n_trials × (the guarded decision's extra ops) + (the initial check's
ops) more than a bare one. It then times the parts on the solve's own
device and shapes, in alternating blocks of guarded and bare decisions
so drift slower than a block cancels, and gates (n_trials × the
decision's extra time + the initial check's time) / ``bare_s``. A guard
that grew work elsewhere fails the count; one that grew a cost in the
decision fails the gate.
"""

from __future__ import annotations

import argparse
import gc
import time
from typing import Callable, Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import ControllerConfig, adaptive_while_solve
from repro_torch.core.integrate import nonfinite_any, trial_decision
from repro_torch.core.tableaus import get_tableau
from repro_torch.device import resolve_device

from .common import emit, emit_json, gate, record, settings, synchronize

GATE_FRAC = 0.05          # the guards may cost at most 5% of the solve
NOISE_FLOOR_S = 1e-3      # below this, timing noise > gate resolution
K = 256
CFG = ControllerConfig(max_steps=65536, max_trials=12)
SETTINGS = {True: dict(t1=40.0, reps=20), False: dict(t1=120.0, reps=50)}
BLOCKS, PER_BLOCK = 100, 200  # the parts' timing: blocks of calls


def _vdp(t, z, mu):
    x, v = z[0], z[1]                     # (2, K) ensemble state
    return torch.stack([v, mu * ((1.0 - x * x) * v) - x])


def problem(t1: float, device):
    """(z0, ts, mu): the reference's ensemble x0 = 2 + 0.1 k / K, v0 = 0,
    and 8 eval times over [0, t1] (f32)."""
    x0 = 2.0 + 0.1 * torch.arange(K, dtype=torch.float32) / K
    z0 = torch.stack([x0, torch.zeros(K)]).to(device)
    ts = torch.linspace(0.0, t1, 8, dtype=torch.float32).to(device)
    return z0, ts, torch.tensor(8.0, device=device)


def solve(z0, ts, mu, guard: bool):
    """One guarded or bare solve: (ys, n_trials)."""
    ys, _, stats = adaptive_while_solve(
        get_tableau("dopri5"), _vdp, z0, ts, (mu,), 1e-9, 1e-9, CFG,
        guard_nonfinite=guard)
    return ys, int(stats.n_trials)


class _OpCounter(TorchDispatchMode):
    """Counts the tensor operations dispatched while it is active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _count(fn: Callable) -> int:
    with _OpCounter() as c:
        fn()
    return c.n


def _parts(z0, ts, mu):
    """The guard's two parts as calls on the solve's device and dtypes:
    {"decision": {guard: one trial's decision}, "initial": the initial
    check}."""
    dev, tdt = z0.device, ts.dtype
    tiny = torch.full((), torch.finfo(tdt).eps, dtype=tdt, device=dev)
    one = torch.ones((), dtype=tdt, device=dev)
    t, t_target = ts[0], ts[1]
    h = torch.full((), 1e-3, dtype=tdt, device=dev)
    h_min = 16.0 * tiny * torch.maximum(torch.abs(t), one)
    args = (CFG, get_tableau("dopri5").order, t, h, h_min, t_target,
            torch.full((), 0.5, device=dev), torch.ones((), device=dev),
            tiny, one, torch.full((), 1e10, device=dev),
            torch.zeros((), dtype=torch.bool, device=dev))
    k0 = _vdp(ts[0], z0, mu)
    return {"decision": {g: (lambda g=g: trial_decision(*args, g))
                         for g in (True, False)},
            "initial": lambda: nonfinite_any(z0, k0, h)}


def guard_ops(dev, t1: float = 2.0) -> Dict[str, int]:
    """Tensor operations on the problem cut to [0, t1]: each solve's, the
    guarded and bare decision's and the initial check's. Gates that the
    guard's work is all in these parts: ``solve_extra == n_trials *
    decision_extra + initial``."""
    z0, ts, mu = problem(t1, dev)
    total, n = {}, {}
    for g in (True, False):
        with _OpCounter() as c:
            _, n[g] = solve(z0, ts, mu, g)
        total[g] = c.n
    parts = _parts(z0, ts, mu)
    dec = {g: _count(parts["decision"][g]) for g in (True, False)}
    ops = {"n_trials": n[True], "solve_guarded": total[True],
           "solve_bare": total[False],
           "solve_extra": total[True] - total[False],
           "decision_guarded": dec[True], "decision_bare": dec[False],
           "decision_extra": dec[True] - dec[False],
           "initial": _count(parts["initial"])}
    gate(ops["solve_extra"] == ops["n_trials"] * ops["decision_extra"]
         + ops["initial"], "the guard does work outside trial_decision "
         "and the initial check", ops)
    return ops


def _median(xs: List[float]) -> float:
    xs = sorted(xs)
    mid = len(xs) // 2
    return xs[mid] if len(xs) % 2 else 0.5 * (xs[mid - 1] + xs[mid])


def per_call_s(calls: Dict[str, Callable], dev, blocks: int = BLOCKS,
               per_block: int = PER_BLOCK) -> Dict[str, float]:
    """Median seconds a call of each of ``calls``, timed in blocks of
    ``per_block`` calls that alternate between them (the order reversed
    every other round)."""
    times: Dict[str, List[float]] = {k: [] for k in calls}
    keys = list(calls)
    for b in range(blocks):
        for k in (keys if b % 2 == 0 else keys[::-1]):
            fn = calls[k]
            synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(per_block):
                fn()
            synchronize(dev)
            times[k].append((time.perf_counter() - t0) / per_block)
    return {k: _median(v) for k, v in times.items()}


def measure(quick: bool = False, device="cuda", **cuts) -> Dict:
    """The solves' times, the guard's op counts and its parts' times;
    returns the numbers the gate reads (no gate)."""
    s = settings(SETTINGS, quick, cuts)
    dev = resolve_device(device)
    z0, ts, mu = problem(s["t1"], dev)
    # equal trials, equal work: the gate prices the guard alone
    _, n_g = solve(z0, ts, mu, True)
    _, n_b = solve(z0, ts, mu, False)
    gate(n_g == n_b, "guarded and bare solves took different trials",
         n_g, n_b)
    ops = guard_ops(dev)
    times: Dict[bool, List[float]] = {True: [], False: []}
    gc.collect()
    gc.disable()
    try:
        # back-to-back pairs, alternating which variant goes first
        for rep in range(max(s["reps"], 2)):
            for guard in ((True, False) if rep % 2 == 0 else (False, True)):
                synchronize(dev)
                t0 = time.perf_counter()
                solve(z0, ts, mu, guard)
                synchronize(dev)
                times[guard].append(time.perf_counter() - t0)
        parts = _parts(z0, ts, mu)
        part_s = per_call_s({"decision_guarded": parts["decision"][True],
                             "decision_bare": parts["decision"][False],
                             "initial": parts["initial"]}, dev)
    finally:
        gc.enable()
    t_g, t_b = min(times[True]), min(times[False])
    decision_extra_s = part_s["decision_guarded"] - part_s["decision_bare"]
    guard_s = n_g * decision_extra_s + part_s["initial"]
    return {"trials": n_g, "guarded_s": t_g, "bare_s": t_b,
            "overhead_frac": guard_s / t_b, "gate_frac": GATE_FRAC,
            "guard_s": guard_s, "decision_extra_us": 1e6 * decision_extra_s,
            "initial_check_us": 1e6 * part_s["initial"],
            "part_us": {k: 1e6 * v for k, v in part_s.items()},
            "whole_solve_overhead_frac": t_g / t_b - 1.0,
            "reps": len(times[True]), "ops": ops}


def run(quick: bool = False, device="cuda", **cuts) -> Dict[str, float]:
    """Emit the rows and apply the gate (``common.GateFailed``); returns
    {row name: value}."""
    m = measure(quick, device, **cuts)
    t_g, t_b, overhead = m["guarded_s"], m["bare_s"], m["overhead_frac"]
    out: Dict[str, float] = {}
    record(out, "failure_overhead/trials", m["trials"], "d",
           "stiff vdp, dopri5")
    record(out, "failure_overhead/guarded_s", t_g, ".5f", "")
    record(out, "failure_overhead/bare_s", t_b, ".5f", "")
    record(out, "failure_overhead/frac", overhead, "+.4f",
           f"gate <= {GATE_FRAC:.2f}; the guard's parts, "
           f"{m['decision_extra_us']:.2f} us a trial")
    emit_json("failure_overhead", m)
    if t_b < NOISE_FLOOR_S:
        out["failure_overhead/gate"] = "SKIP"
        emit("failure_overhead/gate", "SKIP",
             f"bare runtime {t_b:.2e}s under noise floor")
        return out
    gate(overhead <= GATE_FRAC,
         f"solve-health guards cost {overhead:.1%} of the solve (gate "
         f"{GATE_FRAC:.0%}): {m['trials']} trials x "
         f"{m['decision_extra_us']:.2f} us + {m['initial_check_us']:.2f} "
         f"us against t_bare={t_b:.5f}s")
    out["failure_overhead/gate"] = "PASS"
    emit("failure_overhead/gate", "PASS", "")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    run(quick=not a.full, device=a.device)
