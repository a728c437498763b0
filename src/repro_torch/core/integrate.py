"""Adaptive forward integration with the paper's trajectory checkpoint.

Port of ``repro/core/integrate.py::adaptive_while_solve`` and
``batched_adaptive_while_solve`` for the full checkpoint buffer. JAX's
``lax.while_loop`` becomes a host loop. The solo loop reads two 0-d bool
tensors on the host per trial — the loop condition (the counterpart of
the while_loop's ``cond``) and the accept decision; the per-sample
batched loop reads one, ``any(live)``, and keeps every per-row decision
in masks. Everything else stays in tensors on the state's device.
Accepted points (t_i, h_i, z_i) go into a ``Checkpoints`` buffer
preallocated at ``max_steps`` (per row when batched), which the ACA
backward sweep replays. The solve-health guard (``guard_nonfinite``) and
the ``SolveStatus`` codes are kept, per row when batched.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch
from torch.func import vmap

from .controller import ControllerConfig, initial_stepsize, propose_stepsize
from .stepper import batched_field, error_ratio, rk_step, rk_step_batched
from .tableaus import Tableau


def as_tuple(args) -> Tuple:
    """Normalize ``args`` to the *args tuple ``f`` receives."""
    return args if isinstance(args, tuple) else (args,)


class SolveStatus:
    """Structured health codes for a solve (``SolveStats.status``),
    ordered by severity (0 = healthy):

    * ``OK`` — every requested eval time was reached normally.
    * ``NONFINITE_STATE`` — a trial produced a non-finite state or error
      norm even at the minimum stepsize; the solve froze at its last
      accepted state and the ACA backward zeroes its cotangents.
    * ``STEPSIZE_UNDERFLOW`` — a forced-minimum step was accepted while
      still failing the error test.
    * ``TRIAL_BUDGET_EXHAUSTED`` — ``max_steps * max_trials`` trials ran
      out before the last eval time.
    * ``CHECKPOINT_OVERFLOW`` — ``max_steps`` accepted steps (the
      checkpoint capacity) ran out before the last eval time.
    """
    OK = 0
    NONFINITE_STATE = 1
    STEPSIZE_UNDERFLOW = 2
    TRIAL_BUDGET_EXHAUSTED = 3
    CHECKPOINT_OVERFLOW = 4

    _NAMES = {0: "OK", 1: "NONFINITE_STATE", 2: "STEPSIZE_UNDERFLOW",
              3: "TRIAL_BUDGET_EXHAUSTED", 4: "CHECKPOINT_OVERFLOW"}

    @classmethod
    def describe(cls, code) -> str:
        """Human-readable name of one status code."""
        code = int(code)
        return cls._NAMES.get(code, f"UNKNOWN({code})")


class SolveStats(NamedTuple):
    """Cost counters and health status of one solve, as 0-d tensors on
    the state's device ((B,) per row for a batched solve)."""
    n_steps: torch.Tensor     # accepted steps (paper's N_t)
    n_trials: torch.Tensor    # total trials (N_t * m)
    nfe: torch.Tensor         # evaluations of f
    overflow: torch.Tensor    # bool: last eval time not reached
    status: torch.Tensor      # int32 SolveStatus code


class Checkpoints(NamedTuple):
    """The paper's trajectory checkpoint: accepted grid + states.

    ``z[i]`` is the state at the *start* of accepted interval i, ``t[i]``
    and ``h[i]`` its start time and accepted stepsize, ``out_idx[i]`` the
    index into ``ts`` its endpoint landed on (or -1). Only slots [0, n)
    are valid; ``n`` is a host int. A batched solve keeps one row per
    batch element — t, h, out_idx (B, max_steps), z (B, max_steps,
    *state) — and ``n`` is then a (B,) int32 tensor.
    """
    t: torch.Tensor           # (max_steps,)
    h: torch.Tensor           # (max_steps,)
    z: torch.Tensor           # (max_steps, *state)
    out_idx: torch.Tensor     # (max_steps,) int32
    n: Union[int, torch.Tensor]


def nonfinite_any(*tensors: torch.Tensor) -> torch.Tensor:
    """0-d bool: any of ``tensors`` holds a NaN or Inf."""
    out = None
    for x in tensors:
        flag = torch.any(~torch.isfinite(x))
        out = flag if out is None else out | flag
    return out


def nonfinite_rows(*tensors: torch.Tensor) -> torch.Tensor:
    """(B,) bool: row b of any of the batch-leading ``tensors`` holds a
    NaN or Inf."""
    out = None
    for x in tensors:
        flag = torch.any(~torch.isfinite(x.reshape(x.shape[0], -1)), dim=1)
        out = flag if out is None else out | flag
    return out


def _compose_status(failed, uflow, finished, trials_out) -> torch.Tensor:
    """Fold the health flags into one SolveStatus code: non-finite failure
    dominates, then whichever budget cut the solve, then underflow."""
    budget = torch.where(trials_out, SolveStatus.TRIAL_BUDGET_EXHAUSTED,
                         SolveStatus.CHECKPOINT_OVERFLOW)
    tail = torch.where(uflow, SolveStatus.STEPSIZE_UNDERFLOW, SolveStatus.OK)
    status = torch.where(finished, tail, budget)
    return torch.where(failed, SolveStatus.NONFINITE_STATE,
                       status).to(torch.int32)


def _freeze_fill(ys: torch.Tensor, mask: torch.Tensor,
                 z_frozen: torch.Tensor) -> torch.Tensor:
    """Repeat a failed solve's last accepted state into its un-reached
    eval slots (``mask`` (n_eval,), or (n_eval, B) with ``z_frozen``
    (B, ...) when batched); a bitwise no-op where it is False."""
    m = mask.reshape(mask.shape + (1,) * (ys.dim() - mask.dim()))
    return torch.where(m, z_frozen.unsqueeze(0), ys)


@torch.no_grad()
def adaptive_while_solve(
    tab: Tableau,
    f: Callable,
    z0: torch.Tensor,
    ts: torch.Tensor,
    args: Tuple,
    rtol: float,
    atol: float,
    cfg: ControllerConfig,
    h0: Optional[torch.Tensor] = None,
    use_pallas: bool = False,
    guard_nonfinite: bool = True,
) -> Tuple[torch.Tensor, Checkpoints, SolveStats]:
    """Integrate dz/dt = f(t, z, *args) through increasing times ``ts``.

    Returns (ys, checkpoints, stats); ``ys`` is stacked over len(ts) with
    ys[0] = z0. Runs without autograd: the ACA Function differentiates it
    by replaying the checkpoints. ``use_pallas`` selects the fused flat
    stepper path (callers pass an already-flat (N,) state).

    ``guard_nonfinite`` (default on): a trial whose error ratio is not
    finite is never accepted, and once the stepsize has railed at
    ``h_min`` with the trial still non-finite the solve freezes at its
    last accepted state with ``SolveStatus.NONFINITE_STATE``.
    """
    if not tab.adaptive:
        raise ValueError(
            f"adaptive_while_solve needs an embedded adaptive tableau; "
            f"{tab.name!r} is fixed-step (fixed grids are slice B, "
            "ROADMAP queue 1)")
    dev = z0.device
    n_eval = ts.shape[0]
    tdt = ts.dtype
    max_steps = cfg.max_steps
    # trial budget: every accepted step costs >= 1 trial
    max_total_trials = max_steps * cfg.max_trials

    hinit_evals = 2 if h0 is None else 0  # hinit costs 2 f-evals
    if h0 is None:
        h0 = initial_stepsize(f, ts[0], z0, args, tab.order, rtol, atol)
    h = torch.as_tensor(h0, dtype=tdt, device=dev).reshape(())

    ys = torch.zeros((n_eval,) + tuple(z0.shape), dtype=z0.dtype, device=dev)
    ys[0] = z0
    ckpt_t = torch.zeros(max_steps, dtype=tdt, device=dev)
    ckpt_h = torch.zeros_like(ckpt_t)
    ckpt_z = torch.zeros((max_steps,) + tuple(z0.shape), dtype=z0.dtype,
                         device=dev)
    ckpt_oi = torch.full((max_steps,), -1, dtype=torch.int32, device=dev)

    k0 = f(ts[0], z0, *args)
    nfe = 1 + hinit_evals
    false = torch.zeros((), dtype=torch.bool, device=dev)
    # a non-finite initial state / derivative / h0 fails before stepping
    failed = nonfinite_any(z0, k0, h) if guard_nonfinite else false
    uflow = false

    t, z = ts[0], z0
    prev_ratio = torch.ones((), dtype=torch.float32, device=dev)
    i = 0                                   # accepted steps so far
    trials = 0
    eval_idx = torch.ones(1, dtype=torch.int64, device=dev)  # next ts[] to hit
    tiny = torch.full((), torch.finfo(tdt).eps, dtype=tdt, device=dev)
    one = torch.ones((), dtype=tdt, device=dev)
    big_ratio = torch.full((), 1e10, dtype=torch.float32, device=dev)

    # host read 1 of 2 per trial: the loop condition
    while (i < max_steps and trials < max_total_trials
           and bool((eval_idx[0] < n_eval) & ~failed)):
        t_target = ts.index_select(0, eval_idx).reshape(())
        # clamp the trial step to land exactly on the target eval time
        h_min = 16.0 * tiny * torch.maximum(torch.abs(t), one)
        h_use = torch.clamp(h, h_min, t_target - t)
        res = rk_step(tab, f, t, z, h_use, args, k0=k0,
                      use_pallas=use_pallas, err_scale=(rtol, atol))
        nfe += tab.stages - 1

        # fused path: the scaled norm came out of the combine kernel
        ratio = res.err_ratio if res.err_ratio is not None else \
            error_ratio(res.err, z, res.z_next, rtol, atol)
        railed = h_use <= h_min * (1 + 1e-3)
        if guard_nonfinite:
            # one read guards the whole trial: a NaN/Inf anywhere in the
            # stage sums poisons the embedded error, and an Inf state
            # makes the scaled norm Inf/Inf = NaN
            bad = ~torch.isfinite(ratio)
            # forced-minimum steps are accepted (cannot shrink), unless bad
            accept = ((ratio <= 1.0) | railed) & ~bad
        else:
            bad = false
            accept = (ratio <= 1.0) | railed
        # railed + still non-finite -> freeze; forced accept that still
        # fails the error test -> underflow
        failed = failed | (bad & railed)
        uflow = uflow | (accept & railed & (ratio > 1.0))

        t_new = t + h_use
        hit = accept & (t_new >= t_target - 16.0 * tiny * torch.maximum(
            torch.abs(t_target), one))

        # a non-finite ratio would poison the h chain; treat it as "error
        # way too large" so the retry shrinks at max rate
        ratio_c = torch.where(bad, big_ratio, ratio)
        h_next = propose_stepsize(cfg, h_use, ratio_c, prev_ratio,
                                  tab.order).to(tdt)
        trials += 1

        # host read 2 of 2 per trial: accept / reject
        if accept:
            # write the trajectory checkpoint (t_i, h_i, z_i)
            ckpt_t[i] = t
            ckpt_h[i] = h_use
            ckpt_z[i] = z
            ckpt_oi[i] = torch.where(hit, eval_idx[0], -1)
            # record the output at an eval-time hit
            cur = ys.index_select(0, eval_idx)
            ys.index_copy_(0, eval_idx,
                           torch.where(hit, res.z_next.unsqueeze(0), cur))
            eval_idx = eval_idx + hit.to(torch.int64)
            # first-stage reuse: FSAL takes the accepted step's last
            # stage, other tableaus evaluate f at the new point
            if tab.fsal:
                k0 = res.k_last
            else:
                k0 = f(t_new, res.z_next, *args)
                nfe += 1
            t, z = t_new, res.z_next
            prev_ratio = torch.clamp(ratio, min=1e-10)
            i += 1
        h = h_next

    overflow = eval_idx[0] < n_eval
    trials_out = torch.full((), trials >= max_total_trials, dtype=torch.bool,
                            device=dev)
    status = _compose_status(failed, uflow, ~overflow, trials_out)
    # frozen solve: repeat the last accepted state into un-reached slots
    karr = torch.arange(n_eval, device=dev)
    ys_out = _freeze_fill(ys, failed & (karr >= eval_idx[0]), z)
    ckpts = Checkpoints(t=ckpt_t, h=ckpt_h, z=ckpt_z, out_idx=ckpt_oi, n=i)

    def count(v):
        return torch.full((), v, dtype=torch.int32, device=dev)

    stats = SolveStats(n_steps=count(i), n_trials=count(trials),
                       nfe=count(nfe), overflow=overflow, status=status)
    return ys_out, ckpts, stats


# ------------------------------------------------------- per-sample batched

def _row_tolerances(rtol, atol, n_rows: int, device):
    """``((B,), (B,))`` f32 tolerance rows on ``device`` when either is a
    tensor, else None (the scalar path, kept as it is so scalar solves
    keep their bits)."""
    if not (isinstance(rtol, torch.Tensor) or isinstance(atol, torch.Tensor)):
        return None
    return tuple(
        torch.as_tensor(x, dtype=torch.float32, device=device)
        .broadcast_to((n_rows,)).contiguous() for x in (rtol, atol))


def _bwhere(pred: torch.Tensor, a: torch.Tensor,
            b: torch.Tensor) -> torch.Tensor:
    """``torch.where`` with a (B,) predicate over batch-leading tensors."""
    return torch.where(pred.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)


@torch.no_grad()
def batched_adaptive_while_solve(
    tab: Tableau,
    f: Callable,
    z0: torch.Tensor,
    ts: torch.Tensor,
    args: Tuple,
    rtol,
    atol,
    cfg: ControllerConfig,
    h0: Optional[torch.Tensor] = None,
    use_pallas: bool = False,
    guard_nonfinite: bool = True,
) -> Tuple[torch.Tensor, Checkpoints, SolveStats]:
    """Per-sample batched adaptive solve: one loop, one stepsize controller
    per batch row.

    ``z0`` carries a leading batch dimension B; ``f`` is the per-sample
    field (evaluated over the batch with ``torch.func.vmap``). Returns
    (ys (len(ts), B, ...), checkpoints with per-row buffers, stats with
    (B,) fields). Rows never interact: no reduction crosses rows.

    Each trial advances every *live* row one ψ trial with its own
    stepsize; rows that are finished, failed or out of budget take h = 0
    (the identity) and masks keep rejected and finished rows bit-stable.
    The host reads one 0-d bool per trial, ``any(live)``; accept, reject,
    eval-time hits and checkpoint writes are masks and indexed writes on
    the device. ``use_pallas`` expects an already-flat (B, N) state
    (``stepper.maybe_flatten_batched``) and runs kernels K3 and K4/K5.
    ``guard_nonfinite`` as in ``adaptive_while_solve``, per row: a failing
    row freezes with ``SolveStatus.NONFINITE_STATE`` while the others go on.

    ``rtol``/``atol`` are floats, or (B,) tensors: then every row's
    controller (initial stepsize, error norm, accept/reject) targets its
    own tolerance, and a row at tolerance τ gives the bits of the all-τ
    batch's row. ``h0`` is a scalar or (B,) initial stepsize.
    """
    if not tab.adaptive:
        raise ValueError(
            f"batched_adaptive_while_solve needs an embedded adaptive "
            f"tableau; {tab.name!r} is fixed-step (fixed grids are slice B, "
            "ROADMAP queue 1)")
    dev = z0.device
    B = z0.shape[0]
    rows = torch.arange(B, device=dev)
    n_eval = ts.shape[0]
    tdt = ts.dtype
    max_steps = cfg.max_steps
    max_total_trials = max_steps * cfg.max_trials

    row_tol = _row_tolerances(rtol, atol, B, dev)
    if row_tol is not None:
        rtol, atol = row_tol
    hinit_evals = 2 if h0 is None else 0  # hinit costs 2 f-evals per row
    if h0 is None:
        if row_tol is not None:
            h0 = vmap(lambda z, rt, at: initial_stepsize(
                f, ts[0], z, args, tab.order, rt, at))(z0, rtol, atol)
        else:
            h0 = vmap(lambda z: initial_stepsize(
                f, ts[0], z, args, tab.order, rtol, atol))(z0)
    h = torch.as_tensor(h0, dtype=tdt, device=dev).broadcast_to((B,)).clone()

    ys = torch.zeros((n_eval,) + tuple(z0.shape), dtype=z0.dtype, device=dev)
    ys[0] = z0
    ckpt_t = torch.zeros((B, max_steps), dtype=tdt, device=dev)
    ckpt_h = torch.zeros_like(ckpt_t)
    ckpt_z = torch.zeros((B, max_steps) + tuple(z0.shape[1:]),
                         dtype=z0.dtype, device=dev)
    ckpt_oi = torch.full((B, max_steps), -1, dtype=torch.int32, device=dev)

    fb = batched_field(f, args)
    t = ts[0].expand(B).clone()
    k0 = fb(t, z0)
    nfe = torch.full((B,), 1 + hinit_evals, dtype=torch.int32, device=dev)
    # rows starting from a non-finite state/derivative/h0 fail at once
    failed = nonfinite_rows(z0, k0, h) if guard_nonfinite else \
        torch.zeros(B, dtype=torch.bool, device=dev)
    uflow = torch.zeros(B, dtype=torch.bool, device=dev)

    z = z0
    prev_ratio = torch.ones(B, dtype=torch.float32, device=dev)
    i = torch.zeros(B, dtype=torch.int32, device=dev)         # accepted
    eval_idx = torch.ones(B, dtype=torch.int64, device=dev)   # next ts[]
    trials = torch.zeros(B, dtype=torch.int32, device=dev)
    tiny = torch.full((), torch.finfo(tdt).eps, dtype=tdt, device=dev)
    one = torch.ones((), dtype=tdt, device=dev)
    zero_h = torch.zeros((), dtype=tdt, device=dev)
    big_ratio = torch.full((), 1e10, dtype=torch.float32, device=dev)
    minus_one = torch.full((), -1, dtype=torch.int32, device=dev)

    def live_mask():
        return ((eval_idx < n_eval) & (i < max_steps)
                & (trials < max_total_trials) & ~failed)

    live = live_mask()
    # the one host read per trial: any row still live (the while_loop's
    # cond)
    while live.any():
        t_target = ts[eval_idx.clamp(max=n_eval - 1)]           # (B,)
        h_min = 16.0 * tiny * torch.maximum(torch.abs(t), one)
        # dead rows step with h = 0: ψ degenerates to the identity
        h_use = torch.where(live, torch.clamp(h, h_min, t_target - t),
                            zero_h)
        res = rk_step_batched(tab, f, t, z, h_use, args, k0=k0,
                              use_pallas=use_pallas, err_scale=(rtol, atol))
        ratio = res.err_ratio                                   # (B,)
        railed = h_use <= h_min * (1 + 1e-3)
        if guard_nonfinite:
            bad = ~torch.isfinite(ratio)
            accept = live & ((ratio <= 1.0) | railed) & ~bad
        else:
            bad = torch.zeros_like(live)
            accept = live & ((ratio <= 1.0) | railed)
        fail_now = live & bad & railed
        uflow_now = accept & railed & (ratio > 1.0)

        t_new = t + h_use
        hit = accept & (t_new >= t_target - 16.0 * tiny * torch.maximum(
            torch.abs(t_target), one))

        # first-stage reuse per row: FSAL takes the last stage, other
        # tableaus evaluate f at every row's new point (a live row that
        # rejected discards it, as the reference's while_loop body does)
        if tab.fsal:
            k0_acc, nfe_acc = res.k_last, 0
        else:
            k0_acc, nfe_acc = fb(t_new, res.z_next), 1

        # on accept: write each row's own checkpoint slot
        i_c = i.clamp(max=max_steps - 1).long()
        ckpt_t[rows, i_c] = torch.where(accept, t, ckpt_t[rows, i_c])
        ckpt_h[rows, i_c] = torch.where(accept, h_use, ckpt_h[rows, i_c])
        ckpt_z[rows, i_c] = _bwhere(accept, z, ckpt_z[rows, i_c])
        oi_val = torch.where(hit, eval_idx.to(torch.int32), minus_one)
        ckpt_oi[rows, i_c] = torch.where(accept, oi_val, ckpt_oi[rows, i_c])
        # on an eval-time hit: record that row's output
        e_c = eval_idx.clamp(max=n_eval - 1)
        ys[e_c, rows] = _bwhere(hit, res.z_next, ys[e_c, rows])

        # per-row stepsize control; a non-finite ratio shrinks at the
        # maximum rate instead of entering the h chain
        ratio_c = torch.where(bad, big_ratio, ratio)
        h_next = propose_stepsize(cfg, h_use, ratio_c, prev_ratio,
                                  tab.order).to(tdt)

        k0 = _bwhere(accept, k0_acc, k0)
        # finished rows take the h = 0 trial for free: only live rows pay
        # evaluations in the per-row counts
        nfe = nfe + torch.where(live, tab.stages - 1, 0).to(torch.int32) \
            + torch.where(accept, nfe_acc, 0).to(torch.int32)
        t = torch.where(accept, t_new, t)
        z = _bwhere(accept, res.z_next, z)
        h = torch.where(live, h_next, h)
        prev_ratio = torch.where(accept, torch.clamp(ratio, min=1e-10),
                                 prev_ratio)
        i = i + accept.to(torch.int32)
        eval_idx = eval_idx + hit.to(torch.int64)
        trials = trials + live.to(torch.int32)
        failed = failed | fail_now
        uflow = uflow | uflow_now
        live = live_mask()

    overflow = eval_idx < n_eval
    status = _compose_status(failed, uflow, ~overflow,
                             trials >= max_total_trials)
    karr = torch.arange(n_eval, device=dev)
    fill = failed[None, :] & (karr[:, None] >= eval_idx[None, :])
    ys_out = _freeze_fill(ys, fill, z)
    ckpts = Checkpoints(t=ckpt_t, h=ckpt_h, z=ckpt_z, out_idx=ckpt_oi, n=i)
    stats = SolveStats(n_steps=i, n_trials=trials, nfe=nfe,
                       overflow=overflow, status=status)
    return ys_out, ckpts, stats
