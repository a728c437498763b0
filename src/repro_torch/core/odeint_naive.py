"""The naive method — direct back-propagation through the ODE solver.

Port of ``repro/core/odeint_naive.py``, the paper's second baseline (Sec.
3.3): every solver operation, *including the stepsize search*, stays on
the autograd tape. The stepsize chain h_{i+1} = h_i · decay(ê_i) is itself
differentiated, so the graph has depth O(N_f · N_t · m) and autograd keeps
the stage intermediates of every trial — the paper's memory blow-up.

The trial loop runs eagerly under the caller's autograd mode. The
reference encodes it as a ``lax.scan`` over the whole trial budget with
the finished iterations masked (JAX cannot reverse-differentiate a loop
of dynamic length); here the loop stops when the last eval time is
reached or the budget runs out, so the tape holds only the trials taken.
Masked trials carry a zero cotangent in the reference, so the gradient is
the same. ``SolveStats`` count the trials taken (``n_trials``) and their
evaluations without first-stage reuse (``nfe`` = trials × stages), where
the reference reports the budget.

As in the reference: the initial stepsize stays on the tape, the first
stage is evaluated afresh every trial (no FSAL reuse), failure detection
reads detached values, and a trial with a non-finite error norm feeds
``propose_stepsize`` a neutral ratio. On the fused path (``use_pallas``)
the ratio comes from K2's (K4/K5's) norm sum, differentiated through the
kernels' plain versions.

The batched form keeps one controller per row: each trial stacks the
rows still running into one batched ψ, so a finished row takes no trial
and adds nothing to the tape.

``interpolate_ts`` runs the natural grid on the tape: the step is clamped
to ``ts[-1]`` only and the interior eval times an accepted trial covers
are read off its interpolant (``integrate.natural_grid_outputs``); a
non-FSAL pair evaluates f at each trial's end for it, one more
evaluation a trial in ``nfe``, as in the reference.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch

from repro_torch.kernels import cost_hooks

from .controller import ControllerConfig, initial_stepsize, propose_stepsize
from .groups import gdetach, gget, gleaves, gmap, gstack, gunbind
from .integrate import (
    SolveStats,
    _compose_status,
    _row_tolerances,
    as_tuple,
    batched_initial_stepsize,
    covered_evals,
    eval_theta,
    fixed_grid_solve,
    nonfinite_any,
    nonfinite_rows,
)
from .stepper import (
    batched_field,
    error_ratio,
    interp_eval,
    interp_fit,
    maybe_flatten,
    maybe_flatten_batched,
    rk_step,
    rk_step_batched,
)
from .tableaus import Tableau


def _budget(cfg: ControllerConfig, trial_budget: Optional[int]) -> int:
    return trial_budget if trial_budget is not None else (
        cfg.max_steps * cfg.max_trials)


def _trial_step(h, h_min, t, t_target):
    """The trial stepsize clip(h, h_min, max(t_target - t, h_min)), on the
    tape."""
    return torch.minimum(torch.maximum(h, h_min),
                         torch.maximum(t_target - t, h_min))


def _hit(t_new, t_target, tiny, one):
    return t_new >= t_target - 16.0 * tiny * torch.maximum(
        torch.abs(t_target), one)


def _interpolant(ts, t, h_use, z, res, k1):
    """The trial's interpolant at every eval time, on the tape: (n_eval,
    ...) solo, (n_eval, L, ...) for the live rows' (L,) ``t``, ``h_use``."""
    coeffs = interp_fit(z, res.z_next, res.k_first, k1, h_use, res.z_mid)
    return interp_eval(coeffs, eval_theta(ts, t, h_use))


def odeint_naive(
    f: Callable,
    z0: Any,
    ts: torch.Tensor,
    args: Any = (),
    *,
    solver: Tableau,
    rtol: float = 1e-6,
    atol: float = 1e-6,
    cfg: Optional[ControllerConfig] = None,
    trial_budget: Optional[int] = None,
    use_pallas: bool = False,
    h0: Optional[torch.Tensor] = None,
    interpolate_ts: bool = False,
    group=None,
):
    """Differentiable adaptive solve (naive method); returns (ys, stats).

    ``trial_budget`` bounds the trials (accepted or rejected), by default
    ``cfg.max_steps * cfg.max_trials``; ``h0`` overrides the initial
    stepsize heuristic. A fixed-step tableau falls back to
    ``fixed_grid_solve`` with ``cfg.max_steps`` steps per interval, as in
    the reference.

    Solve health: a non-finite trial is never accepted; once the stepsize
    rails at ``h_min`` with the trial still non-finite the solve freezes
    at its last accepted state (``SolveStatus.NONFINITE_STATE``), the
    un-reached outputs repeat it off the tape. The failing trial stays on
    the tape, so gradients after a fault need not be finite.

    ``group`` (a ``distributed.regions.SolveGroup``): ``z0`` is this
    rank's block of a split state; the norms and the guard are the whole
    state's (differentiable sums), so every rank takes the same trials.
    """
    if cfg is None:
        cfg = ControllerConfig()
    if not solver.adaptive:
        return fixed_grid_solve(solver, f, z0, ts, as_tuple(args),
                                steps_per_interval=cfg.max_steps,
                                use_pallas=use_pallas)
    f, z0, unravel, use_pallas = maybe_flatten(f, z0, use_pallas)
    dev = gleaves(z0)[0].device
    n_eval = ts.shape[0]
    tdt = ts.dtype
    budget = _budget(cfg, trial_budget)
    targs = as_tuple(args)
    tiny = torch.full((), torch.finfo(tdt).eps, dtype=tdt, device=dev)
    one = torch.ones((), dtype=tdt, device=dev)

    if h0 is None:
        h = initial_stepsize(f, ts[0], z0, targs, solver.order, rtol, atol,
                             group)
    else:
        h = torch.as_tensor(h0, device=dev)
    h = h.to(tdt).reshape(())

    t, z = ts[0], z0
    prev_ratio = torch.ones((), dtype=torch.float32, device=dev)
    ys: List[Optional[torch.Tensor]] = [z0] + [None] * (n_eval - 1)
    eval_idx, n_acc, trials = 1, 0, 0
    failed = bool(nonfinite_any(gdetach(z0), h.detach(), group=group))
    uflow = False
    natural = interpolate_ts
    # one host read per trial: the trial's decisions
    cost_hooks.loop_enter("naive-trial", dynamic=False)
    while eval_idx < n_eval and not failed and trials < budget:
        cost_hooks.trial(carry=(t, z, h))
        # the natural grid lands on the last eval time only
        t_target = ts[n_eval - 1] if natural else ts[eval_idx]
        h_min = 16.0 * tiny * torch.maximum(torch.abs(t), one)
        h_use = _trial_step(h, h_min, t, t_target)
        # no first-stage reuse: the whole trial goes on the tape
        res = rk_step(solver, f, t, z, h_use, targs, use_pallas=use_pallas,
                      err_scale=(rtol, atol), dense=natural, group=group)
        ratio = res.err_ratio if res.err_ratio is not None else \
            error_ratio(res.err, z, res.z_next, rtol, atol, group)
        railed = h_use <= h_min * (1 + 1e-3)
        # detection reads detached values: no edges added to the tape
        bad = nonfinite_any(gdetach(res.z_next), ratio.detach(),
                            group=group)
        accept = ((ratio <= 1.0) | railed) & ~bad
        t_new = t + h_use
        hit = accept & _hit(t_new, t_target, tiny, one)
        # the differentiated stepsize chain; a non-finite ratio enters it
        # as a neutral 1
        ratio_h = torch.where(bad, torch.ones_like(ratio), ratio)
        h_next = propose_stepsize(cfg, h_use, ratio_h, prev_ratio,
                                  solver.order).to(tdt)
        flags = [accept, hit, bad & railed, accept & railed & (ratio > 1.0)]
        if natural:
            # the trial's end derivative for the interpolant (a non-FSAL
            # pair evaluates it every trial, as the reference does)
            k1 = res.k_last if solver.fsal else f(t_new, res.z_next, *targs)
            flags.append(covered_evals(ts, eval_idx, t_new.detach(),
                                       hit).sum(dim=0))
        acc, hit_now, fail_now, uflow_now, *n_cov = torch.stack(
            [x.to(torch.int64) for x in flags]).tolist()
        trials += 1
        if acc:
            if natural and n_cov[0]:
                # the interior eval times this step covers, interpolated
                yint = _interpolant(ts, t, h_use, z, res, k1)
                for k in range(eval_idx, eval_idx + n_cov[0]):
                    ys[k] = gget(yint, k)
                eval_idx += n_cov[0]
            t, z = t_new, res.z_next
            prev_ratio = torch.clamp(ratio, min=1e-10)
            n_acc += 1
            if hit_now:
                ys[eval_idx] = z
                eval_idx += 1
        failed = failed or fail_now
        uflow = uflow or uflow_now
        h = h_next
    cost_hooks.loop_exit()

    # un-reached slots: a frozen solve repeats its last state off the tape
    fill = gdetach(z) if failed else gmap(torch.zeros_like, z0)
    ys_out = gstack([y if y is not None else fill for y in ys])
    if unravel is not None:
        ys_out = unravel(ys_out)

    def flag(v):
        return torch.full((), v, dtype=torch.bool, device=dev)

    def count(v):
        return torch.full((), v, dtype=torch.int32, device=dev)

    overflow = flag(eval_idx < n_eval)
    status = _compose_status(flag(failed), flag(uflow), ~overflow,
                             flag(trials >= budget))
    stats = SolveStats(n_steps=count(n_acc), n_trials=count(trials),
                       nfe=count(trials * _evals_per_trial(solver,
                                                           interpolate_ts)),
                       overflow=overflow, status=status)
    return ys_out, stats


def _evals_per_trial(solver: Tableau, interpolate_ts: bool) -> int:
    """A trial's evaluations: the stages, and on the natural grid a non-FSAL
    pair's end derivative."""
    return solver.stages + (1 if interpolate_ts and not solver.fsal else 0)


def odeint_naive_batched(
    f: Callable,
    z0: Any,
    ts: torch.Tensor,
    args: Any = (),
    *,
    solver: Tableau,
    rtol=1e-6,
    atol=1e-6,
    cfg: Optional[ControllerConfig] = None,
    trial_budget: Optional[int] = None,
    use_pallas: bool = False,
    h0: Optional[torch.Tensor] = None,
    interpolate_ts: bool = False,
):
    """Per-sample batched naive method: ``odeint(..., batch_axis=0)``
    with autograd through each row's own trial loop.

    Every leaf of ``z0`` carries a leading batch dimension B and ``f`` is
    the per-sample field. Each trial advances the rows still running in
    one batched ψ (``rk_step_batched``: K3 and K4/K5 on the fused path),
    each with its own stepsize, accept/reject decision and differentiated
    stepsize chain; a row that reached its last eval time, failed or ran
    out of ``trial_budget`` (shared, per row) takes no further trial.
    ``rtol``/``atol`` may be (B,) tensors; ``h0`` a scalar or (B,).
    ``ts`` is (T,), or (B, T) with each row's own eval times. Returns
    (ys (T, B, ...), stats with (B,) fields). ``interpolate_ts`` as in
    ``odeint_naive``, per row (a 1-D ``ts`` only).
    """
    if cfg is None:
        cfg = ControllerConfig()
    if not solver.adaptive:
        raise ValueError(
            "odeint_naive_batched requires an embedded adaptive tableau; "
            "fixed grids batch losslessly through odeint_naive_fixed")
    if interpolate_ts and ts.dim() != 1:
        raise ValueError("interpolate_ts reads every row off one shared "
                         "1-D ts; per-row (B, T) ts are not supported")
    f, z0, unravel, use_pallas = maybe_flatten_batched(f, z0, use_pallas)
    dev = gleaves(z0)[0].device
    B = gleaves(z0)[0].shape[0]
    n_eval = ts.shape[-1]
    ts_rows = ts.expand(B, n_eval)
    tdt = ts.dtype
    budget = _budget(cfg, trial_budget)
    targs = as_tuple(args)
    tiny = torch.full((), torch.finfo(tdt).eps, dtype=tdt, device=dev)
    one = torch.ones((), dtype=tdt, device=dev)

    row_tol = _row_tolerances(rtol, atol, B, dev)
    if h0 is not None:
        h_init = torch.as_tensor(h0, device=dev).broadcast_to((B,))
    else:
        h_init = batched_initial_stepsize(
            f, ts, z0, targs, solver.order,
            *((rtol, atol) if row_tol is None else row_tol))
    h_init = h_init.to(tdt)

    # per-row carries as lists of tensors on the tape
    z_rows = gunbind(z0)
    t_rows = list(ts_rows[:, 0].unbind(0))
    h_rows = list(h_init.unbind(0))
    prev_rows = [torch.ones((), dtype=torch.float32, device=dev)] * B
    ys: List[List[Optional[torch.Tensor]]] = [z_rows[:]] + [
        [None] * B for _ in range(n_eval - 1)]
    eval_idx = [1] * B
    n_acc = [0] * B
    trials = [0] * B
    failed = nonfinite_rows(gdetach(z0), h_init.detach()).tolist()
    uflow = [False] * B

    def running():
        return [b for b in range(B) if eval_idx[b] < n_eval
                and not failed[b] and trials[b] < budget]

    live = running()
    # one host read per trial: the running rows' four decisions
    cost_hooks.loop_enter("naive-trial-batched", dynamic=False)
    while live:
        cost_hooks.trial()
        sel = torch.tensor(live, device=dev)
        z = gstack([z_rows[b] for b in live])
        t = torch.stack([t_rows[b] for b in live])
        h = torch.stack([h_rows[b] for b in live])
        prev_ratio = torch.stack([prev_rows[b] for b in live])
        e_live = torch.tensor([eval_idx[b] for b in live], device=dev)
        # the natural grid lands on the last eval time only
        t_target = ts_rows[sel, n_eval - 1] if interpolate_ts else \
            ts_rows[sel, e_live]
        h_min = 16.0 * tiny * torch.maximum(torch.abs(t), one)
        h_use = _trial_step(h, h_min, t, t_target)
        tol = (rtol, atol) if row_tol is None else (
            row_tol[0][sel], row_tol[1][sel])
        res = rk_step_batched(solver, f, t, z, h_use, targs,
                              use_pallas=use_pallas, err_scale=tol,
                              dense=interpolate_ts)
        ratio = res.err_ratio
        railed = h_use <= h_min * (1 + 1e-3)
        bad = nonfinite_rows(gdetach(res.z_next)) | \
            ~torch.isfinite(ratio.detach())
        accept = ((ratio <= 1.0) | railed) & ~bad
        t_new = t + h_use
        hit = accept & _hit(t_new, t_target, tiny, one)
        ratio_h = torch.where(bad, torch.ones_like(ratio), ratio)
        h_next = propose_stepsize(cfg, h_use, ratio_h, prev_ratio,
                                  solver.order).to(tdt)
        flags = [accept, hit, bad & railed, accept & railed & (ratio > 1.0)]
        if interpolate_ts:
            k1 = res.k_last if solver.fsal else \
                batched_field(f, targs)(t_new, res.z_next)
            flags.append(covered_evals(ts, e_live, t_new.detach(),
                                       hit).sum(dim=0))
        acc, hits, fails, uflows, *n_cov = torch.stack(
            [x.to(torch.int64) for x in flags]).tolist()
        yint = None
        if interpolate_ts and any(a and c for a, c in zip(acc, n_cov[0])):
            yint = _interpolant(ts, t, h_use, z, res, k1)
        zn, tn, hn = gunbind(res.z_next), t_new.unbind(0), h_next.unbind(0)
        rn = torch.clamp(ratio, min=1e-10).unbind(0)
        for j, b in enumerate(live):
            trials[b] += 1
            h_rows[b] = hn[j]
            if acc[j]:
                if yint is not None:
                    # this row's covered interior eval times
                    for k in range(eval_idx[b], eval_idx[b] + n_cov[0][j]):
                        ys[k][b] = gget(yint, (k, j))
                    eval_idx[b] += n_cov[0][j]
                z_rows[b], t_rows[b], prev_rows[b] = zn[j], tn[j], rn[j]
                n_acc[b] += 1
                if hits[j]:
                    ys[eval_idx[b]][b] = zn[j]
                    eval_idx[b] += 1
            failed[b] = failed[b] or fails[j]
            uflow[b] = uflow[b] or uflows[j]
        live = running()
    cost_hooks.loop_exit()

    zero = gmap(lambda x: torch.zeros_like(x[0]), z0)
    ys_out = gstack([
        gstack([y if y is not None else
                (gdetach(z_rows[b]) if failed[b] else zero)
                for b, y in enumerate(row)]) for row in ys])
    if unravel is not None:
        ys_out = unravel(ys_out)

    def per_row(v, dtype):
        return torch.tensor(v, dtype=dtype, device=dev)

    overflow = per_row([e < n_eval for e in eval_idx], torch.bool)
    status = _compose_status(per_row(failed, torch.bool),
                             per_row(uflow, torch.bool), ~overflow,
                             per_row([n >= budget for n in trials],
                                     torch.bool))
    stats = SolveStats(n_steps=per_row(n_acc, torch.int32),
                       n_trials=per_row(trials, torch.int32),
                       nfe=per_row([n * _evals_per_trial(solver,
                                                         interpolate_ts)
                                    for n in trials], torch.int32),
                       overflow=overflow, status=status)
    return ys_out, stats


def odeint_naive_fixed(
    f: Callable,
    z0: Any,
    ts: torch.Tensor,
    args: Any = (),
    *,
    solver: Tableau,
    steps_per_interval: int = 8,
    use_pallas: bool = False,
):
    """Naive fixed grid: autograd through the grid loop (every stage on the
    tape, O(N_f · N_t) memory, no recompute). Returns (ys, stats)."""
    return fixed_grid_solve(solver, f, z0, ts, as_tuple(args),
                            steps_per_interval, use_pallas=use_pallas)
