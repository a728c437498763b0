"""Rule passes over recorded runs of the port's solver entry points.

The counterpart of ``repro/analysis/rules_jaxpr.py``, with its four
passes, each named as the reference names it. The reference checks
jaxprs; the port checks what a ``graph_walk.Recorder`` saw while the
entry point ran (forward and backward) and the autograd graph the
forward left:

* ``residual-budget`` — each engine ``autograd.Function`` node's
  residuals (``graph_walk.residual_info``: saved tensors plus every tensor
  its context holds) against the configuration's budget (ACA at
  O((K + N/K)·dim), MALI at O(1) states, the adjoint at O(dim·n_eval)); a
  "lost sight" finding when the forward's graph holds no engine node.
* ``collective-in-loop`` — no c10d collective inside a loop of the solver
  (the sharded solve's roofline: its collectives, two forward and two
  backward, all outside the trial loops); those outside loops are allowed.
* ``host-sync`` — host reads counted per loop: every kind of loop is
  pinned at what it reads today (``LOOP_READS``: reads before its first
  iteration, reads an iteration); outside loops only the sites of
  ``HOST_READ_SITES``, each pinned at its reads in one run, with its
  reason (the ``on_failure="warn"`` status read in ``core/api.py``
  first).
* ``dtype-contract`` — no float-width cast (f32↔f64, bf16↔f32, …) inside a
  loop outside the mixed-dtype groups path, and every loop's carried
  tensors (the state, t and h of a trial loop, λ of a sweep) keep the
  dtypes of its first iteration.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from .findings import Finding
from .graph_walk import Event, Recorder, engine_functions, residual_info

#: reads each kind of loop may make: (before its first iteration, in one
#: iteration), with where they are. A trial loop's first test reads before
#: the first trial; each trial reads its accept decision (solo) and the
#: next test, the last of which is the exit test.
LOOP_READS: Dict[str, Tuple[int, int, str]] = {
    "trial": (1, 2, "core/integrate.py::adaptive_while_solve: the loop "
              "test and the accept decision, two 0-d bools a trial"),
    "trial-batched": (1, 1, "core/integrate.py::batched_adaptive_while_"
                      "solve: any(live), the loop test"),
    "mali-trial": (1, 2, "core/integrate.py::mali_adaptive_solve: the loop "
                   "test and the accept decision"),
    "mali-trial-batched": (1, 1, "core/integrate.py::batched_mali_adaptive_"
                           "solve: any(live)"),
    "naive-trial": (0, 1, "core/odeint_naive.py::odeint_naive: the trial's "
                    "four decisions in one tolist (the loop test is on "
                    "host ints)"),
    "naive-trial-batched": (0, 1, "core/odeint_naive.py::odeint_naive_"
                            "batched: the running rows' decisions in one "
                            "tolist, one read a trial, not one a row"),
    "fixed-grid": (0, 0, "core/integrate.py::fixed_grid_solve, "
                   "odeint_aca.py::_fixed_checkpoint_solve: none"),
    "adjoint-reverse": (0, 0, "core/odeint_adjoint.py::_adjoint_backward: "
                        "none outside each segment's reverse trial loop"),
    "aca-sweep": (0, 0, "core/odeint_aca.py::_aca_backward_sweep: none "
                  "(the step count is a host int)"),
    "aca-sweep-batched": (0, 0, "none (max_b n_b read once before)"),
    "aca-segments": (0, 0, "core/odeint_aca.py::_aca_backward_sweep_"
                     "segmented: none"),
    "aca-segments-batched": (0, 0, "none (the windows planned from one "
                             "read of n before)"),
    "mali-sweep": (0, 0, "core/odeint_mali.py::mali_backward_sweep: none"),
    "mali-sweep-batched": (0, 0, "none (max_b n_b read once before)"),
}

#: the only places outside loops that may read on the host, each pinned
#: at the reads it makes in one run (forward and backward) of a config:
#: (path, function) -> (reads, why)
HOST_READ_SITES: Dict[Tuple[str, str], Tuple[int, str]] = {
    ("repro_torch/core/api.py", "_failure_message"): (
        1, 'on_failure="warn" (and "raise"): one read of stats.status '
        "after the solve, the reference's jax.debug.print site"),
    ("repro_torch/core/api.py", "_ts_direction"): (
        2, "the direction of ts, once a solve before any loop (one read "
        "for ascending times, two for descending)"),
    ("repro_torch/core/odeint_naive.py", "odeint_naive"): (
        1, "the initial state's finiteness, once before the trial loop"),
    ("repro_torch/core/odeint_naive.py", "odeint_naive_batched"): (
        1, "the rows' initial finiteness, one tolist before the trial "
        "loop, not one a row"),
    ("repro_torch/core/odeint_aca.py", "_aca_backward_sweep_batched"): (
        1, "the replay length max_b n_b, once before the batched sweep"),
    ("repro_torch/core/odeint_aca.py",
     "_aca_backward_sweep_segmented_batched"): (
        1, "every row's step count in one tolist, to plan the replay "
        "windows"),
    ("repro_torch/core/odeint_mali.py", "mali_backward_sweep"): (
        1, "the replay length max_b n_b, once before the batched sweep"),
    ("repro_torch/distributed/collectives.py", "__init__"): (
        2, "BatchShard finds its rank on the mesh's rank grid (a CPU "
        "tensor) once a solve: one nonzero and one tolist (one rank)"),
}

#: where a float-width cast inside a loop is the contract: a state of
#: mixed floating dtypes computes each group in its own dtype
MIXED_DTYPE_SITES: Tuple[Tuple[str, Optional[str]], ...] = (
    ("repro_torch/core/groups.py", None),
    ("repro_torch/core/stepper.py", "_weight_in"),
    ("repro_torch/core/stepper.py", "_flat_maps"),
)


def _finding(rule: str, e: Event, message: str, key: str) -> Finding:
    return Finding(rule=rule, path=e.path, line=e.line, message=message,
                   snippet=key)


def _dedup(findings: Iterable[Finding]) -> List[Finding]:
    seen, out = set(), []
    for f in findings:
        k = (f.rule, f.path, f.line, f.snippet)
        if k not in seen:
            seen.add(k)
            out.append(f)
    return out


def check_collectives(rec: Recorder, config_name: str) -> List[Finding]:
    """No c10d collective inside a loop of the solver."""
    return _dedup(
        _finding("collective-in-loop", e,
                 f"[{config_name}] collective '{e.op}' ({e.detail}) at loop "
                 f"depth {e.depth}: per-iteration collectives break the "
                 "shard-local-sweep roofline",
                 f"{config_name}:{e.op}")
        for e in rec.of("collective") if e.depth > 0)


def _extra(loop, events: List[Event], pin: int) -> Event:
    """The read to blame when ``events`` exceed ``pin``: the first made
    outside the loop's own function, else the first past the pin."""
    foreign = [e for e in events if (e.path, e.func) != (loop.path,
                                                          loop.func)]
    return foreign[0] if foreign else events[pin]


def check_host_sync(rec: Recorder, config_name: str) -> List[Finding]:
    """Reads per loop within ``LOOP_READS``; outside loops only the
    ``HOST_READ_SITES``, each within its pin."""
    out = []
    reads = rec.of("read")
    at_site: Dict[Tuple[str, str], int] = {}
    for e in reads:
        if e.loop is not None:
            continue
        site = (e.path, e.func)
        at_site[site] = n = at_site.get(site, 0) + 1
        if site not in HOST_READ_SITES:
            out.append(_finding(
                "host-sync", e,
                f"[{config_name}] host read '{e.op}' in {e.func} outside "
                "the listed sites (HOST_READ_SITES; the documented "
                'on_failure="warn" site in core/api.py first)',
                f"{config_name}:{e.op}"))
        elif n == HOST_READ_SITES[site][0] + 1:
            out.append(_finding(
                "host-sync", e,
                f"[{config_name}] host read '{e.op}' in {e.func}: read "
                f"{n} of a site pinned at {HOST_READ_SITES[site][0]} "
                "(HOST_READ_SITES)",
                f"{config_name}:{e.func}:{e.op}"))
    for idx, loop in enumerate(rec.loops):
        pin = LOOP_READS.get(loop.kind)
        mine = [e for e in reads if e.loop == idx]
        if pin is None:
            if mine:
                out.append(_finding(
                    "host-sync", mine[0],
                    f"[{config_name}] host read '{mine[0].op}' in a loop "
                    f"of kind '{loop.kind}', which LOOP_READS does not pin",
                    f"{config_name}:{loop.kind}"))
            continue
        entry, per_iter, _ = pin
        over = None
        if loop.entry_reads > entry:
            over = _extra(loop, [e for e in mine if e.iteration < 0], entry)
            what = (f"{loop.entry_reads} host reads before the first "
                    f"iteration, pinned at {entry}")
        else:
            for it, n in enumerate(loop.reads):
                if n > per_iter:
                    over = _extra(loop, [e for e in mine
                                         if e.iteration == it], per_iter)
                    what = (f"{n} host reads in iteration {it}, pinned at "
                            f"{per_iter}")
                    break
        if over is not None:
            out.append(_finding(
                "host-sync", over,
                f"[{config_name}] host read '{over.op}' at loop depth "
                f"{over.depth} ('{loop.kind}' loop): {what}; host "
                "round-trips serialize the hot loop",
                f"{config_name}:{loop.kind}:{over.op}"))
    return _dedup(out)


def _mixed_dtype_site(e: Event) -> bool:
    return any(e.path == p and (f is None or e.func == f)
               for p, f in MIXED_DTYPE_SITES)


def check_dtype_contract(rec: Recorder, config_name: str) -> List[Finding]:
    """No float-width cast inside a loop (bar the mixed-dtype groups
    path); loop carries keep the dtypes of their first iteration."""
    out = []
    for e in rec.of("cast"):
        if e.depth > 0 and not _mixed_dtype_site(e):
            out.append(_finding(
                "dtype-contract", e,
                f"[{config_name}] {e.detail} cast ({e.op}) at loop depth "
                f"{e.depth}: mixed-precision arithmetic in the loop",
                f"{config_name}:cast:{e.detail}"))
    for e in rec.of("carry"):
        out.append(_finding(
            "dtype-contract", e,
            f"[{config_name}] the carry of a '{e.op}' loop changed dtype "
            f"{e.detail}: the state, t and h keep their entry dtype",
            f"{config_name}:carry:{e.op}"))
    return _dedup(out)


def check_residual_budget(source, config) -> List[Finding]:
    """Gate each engine node's residual bytes against
    ``config.residual_budget_bytes()``, naming the largest leaves of an
    engine over it. ``source`` is a ``SolveRun`` (its residuals read after
    the forward) or a forward's outputs, whose graph is walked here."""
    budget = config.residual_budget_bytes()
    if budget is None:  # naive: no engine Function to audit
        return []
    residuals = getattr(source, "residuals", None)
    if residuals is None:
        residuals = [residual_info(n) for n in engine_functions(source)]
    if not residuals:
        return [Finding(
            rule="residual-budget", path=config.name, line=0,
            message=(f"[{config.name}] no engine autograd.Function found "
                     "in the forward's graph: the residual auditor has "
                     f"lost sight of the '{config.grad_method}' engine "
                     "boundary"),
            snippet=f"{config.name}:missing-engine-function")]
    out = []
    for info in residuals:
        total = info.total_bytes
        if total > budget:
            top = sorted(info.bytes_by_leaf().items(),
                         key=lambda kv: -kv[1])[:4]
            detail = ", ".join(f"{k}={v}B" for k, v in top)
            out.append(Finding(
                rule="residual-budget", path=info.path, line=info.line,
                message=(f"[{config.name}] residual bytes {total} exceed "
                         f"the {config.grad_method} budget {budget} "
                         f"(slots={config.state_slots()}, dim={config.dim});"
                         f" largest leaves: {detail}"),
                snippet=f"{config.name}:residual-budget"))
    return out


def runs(configs: Iterable, device: str = "cpu", backward: bool = True
         ) -> Iterator[Tuple[object, object]]:
    """Yield ``(config, run)`` for each config run on ``device``; the
    sharded ones run in one process group (``process_group``: started
    here when none runs, destroyed when the loop ends)."""
    from .entry_points import process_group

    configs = list(configs)
    with (process_group(device) if any(c.sharded for c in configs)
          else contextlib.nullcontext()):
        for cfg in configs:
            yield cfg, cfg.run(device, backward=backward)


def static_residual_bytes(config, device: str = "cpu") -> int:
    """Total residual bytes of a config's engine nodes after its forward
    (the counterpart of the reference's symbolic count)."""
    (_, run), = runs([config], device, backward=False)
    return run.residual_bytes


def analyze_run(run) -> List[Finding]:
    """The four passes over one recorded run (forward and backward)."""
    cfg, rec = run.config, run.recorder
    return (check_residual_budget(run, cfg)
            + check_collectives(rec, cfg.name)
            + check_host_sync(rec, cfg.name)
            + check_dtype_contract(rec, cfg.name))


def analyze_matrix(configs: Iterable, device: str = "cpu") -> List[Finding]:
    return [f for _, run in runs(configs, device) for f in analyze_run(run)]


def analyze_config(config, device: str = "cpu") -> List[Finding]:
    """Run one config on ``device`` and apply the four passes."""
    return analyze_matrix([config], device)


def profile(run) -> dict:
    """What a run's passes read, to hold one device's run against
    another's: every loop's reads (before its first iteration and per
    iteration), the reads outside loops, the collectives and the residual
    bytes."""
    rec = run.recorder
    return {
        "loops": [(L.kind, L.depth, L.entry_reads, tuple(L.reads))
                  for L in rec.loops],
        "reads_outside": sorted((e.path, e.func, e.op)
                                for e in rec.of("read") if e.loop is None),
        "collectives": [(e.op, e.depth) for e in rec.of("collective")],
        "residual_bytes": run.residual_bytes,
    }
