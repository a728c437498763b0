"""Adaptive forward integration with the paper's trajectory checkpoint.

Port of ``repro/core/integrate.py::adaptive_while_solve`` and
``batched_adaptive_while_solve``. JAX's
``lax.while_loop`` becomes a host loop. The solo loop reads two 0-d bool
tensors on the host per trial — the loop condition (the counterpart of
the while_loop's ``cond``) and the accept decision; the per-sample
batched loop reads one, ``any(live)``, and keeps every per-row decision
in masks. Everything else stays in tensors on the state's device.
Accepted points (t_i, h_i, z_i) go into a ``Checkpoints`` buffer
preallocated at ``max_steps`` (per row when batched), which the ACA
backward sweep replays; ``checkpoint=False`` (the adjoint's forward)
allocates none. With ``checkpoint_segments=K`` the state buffer shrinks
to K snapshots, one every ``seg_len = ceil(max_steps / K)`` accepted
steps, each beside the first-stage carry k0 it started with, while the
scalar grids t, h, out_idx keep every step: the segmented ACA sweep
re-integrates each segment from its snapshot. ``interpolate_ts`` is the
natural-grid mode: the step is clamped only to ``ts[-1]``, interior
outputs are read off each accepted step's interpolant
(``stepper.interp_fit``) and every interval records the eval indices it
covered (``ev_lo``, ``ev_hi``); ``store_coeffs`` also keeps every step's
interpolant (``odeint_dense``). The solve-health guard
(``guard_nonfinite``) and the ``SolveStatus`` codes are kept, per row
when batched.

``fixed_grid_solve`` integrates on the uniform grid of ``make_fixed_grid``
with one ψ per grid step; autograd through its loop is the naive method
for fixed-step solvers.

``mali_adaptive_solve`` and ``batched_mali_adaptive_solve`` run the same
trial loop (the same host reads a trial) on the asynchronous-leapfrog pair
of ``stepper.alf_step``: the carry is the integer-lattice pair (z, v) and
the only per-step record is the scalar grid (``MaliGrid``), which the
MALI backward sweep inverts from the terminal pair.

Every engine takes a state of dtype groups (``core/groups.py``) as well
as one tensor: its buffers, masks and writes then hold one tensor per
group.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple, Union

import torch
from torch.func import vmap

from repro_torch.kernels import cost_hooks

from .controller import ControllerConfig, initial_stepsize, propose_stepsize
from .groups import gdetach, gget, gleaves, gmap, gset, gstack, gzeros
from .stepper import (
    ALF_ORDER,
    InterpCoeffs,
    alf_lattice_exponent,
    alf_lattice_exponent_batched,
    alf_step,
    alf_step_batched,
    batched_field,
    error_ratio,
    error_ratio_batched,
    interp_eval,
    interp_fit,
    lattice_decode,
    lattice_encode,
    maybe_flatten,
    rk_step,
    rk_step_batched,
)
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

    Segmented (``checkpoint_segments=K``): ``z`` holds K snapshots, slot s
    the state at accepted step ``s * seg_len``, and ``k0`` the first-stage
    derivative that step consumed, so a re-integration chains FSAL reuse
    as the forward did and repeats its states bit for bit. Natural grid
    (``interpolate_ts``): ``out_idx`` marks only the last eval time, and
    ``ev_lo[i]``/``ev_hi[i]`` the half-open range of eval indices read off
    interval i's interpolant; ``coeffs`` (``store_coeffs``) every
    interval's interpolant, leaves (max_steps, *state).
    """
    t: torch.Tensor           # (max_steps,)
    h: torch.Tensor           # (max_steps,)
    z: torch.Tensor           # (max_steps, *state) or (K, *state)
    out_idx: torch.Tensor     # (max_steps,) int32
    n: Union[int, torch.Tensor]
    k0: Optional[torch.Tensor] = None       # (K, *state) snapshots
    ev_lo: Optional[torch.Tensor] = None    # (max_steps,) int32
    ev_hi: Optional[torch.Tensor] = None    # (max_steps,) int32
    coeffs: Optional[InterpCoeffs] = None


def resolve_checkpoint_segments(spec, max_steps: int) -> Optional[int]:
    """A ``checkpoint_segments`` spec as an int K, or None: None keeps the
    full buffer, ``"auto"`` is K = ceil(sqrt(max_steps)) (the optimum of
    the O(K + max_steps / K) cost), an int is clamped to [1, max_steps]."""
    if spec is None:
        return None
    if spec == "auto":
        return max(1, int(-(-max_steps ** 0.5 // 1)))  # ceil(sqrt)
    k = int(spec)
    if k < 1:
        raise ValueError(
            f"checkpoint_segments must be >= 1 or 'auto'; got {spec}")
    return min(k, max_steps)


def segment_length(n_segments: int, max_steps: int) -> int:
    """Steps per checkpoint segment: ceil(max_steps / K)."""
    return -(-max_steps // n_segments)


def resolve_segmentation(spec, max_steps: int
                         ) -> Tuple[Optional[int], Optional[int]]:
    """``(n_seg, seg_len)`` of a ``checkpoint_segments`` spec; ``(None,
    None)`` for the full buffer, which a spec with seg_len 1 (K >=
    max_steps) also gets: every step would be a snapshot anyway."""
    n_seg = resolve_checkpoint_segments(spec, max_steps)
    if n_seg is None:
        return None, None
    seg_len = segment_length(n_seg, max_steps)
    if seg_len == 1:
        return None, None
    return n_seg, seg_len


def _snapshot_layout(n_seg: Optional[int], max_steps: int
                     ) -> Tuple[int, int]:
    """(state slots, seg_len) of an engine's buffer; ``n_seg=None`` is the
    full buffer."""
    if n_seg is None:
        return max_steps, 1
    return n_seg, segment_length(n_seg, max_steps)


def eval_theta(ts: torch.Tensor, t: torch.Tensor,
               h: torch.Tensor) -> torch.Tensor:
    """Each eval time's position in the interval (t, h), clipped to [0, 1]:
    (n_eval,) for a 0-d interval, (n_eval, B) for (B,) intervals."""
    tiny = torch.full((), torch.finfo(ts.dtype).eps, dtype=ts.dtype,
                      device=ts.device)
    if t.dim():
        ts, t, h = ts[:, None], t[None, :], h[None, :]
    return torch.clamp((ts - t) / torch.maximum(h, tiny), 0.0, 1.0)


def covered_evals(ts: torch.Tensor, eval_idx, t_new: torch.Tensor,
                  hit: torch.Tensor) -> torch.Tensor:
    """The interior eval times an accepted interval ending at ``t_new``
    covers in natural-grid mode: not yet written (from ``eval_idx`` on),
    before the last, at or before ``t_new``, or all of them on the final
    landing, so none is skipped. (n_eval,) solo, (n_eval, B) for (B,)
    ``eval_idx``, ``t_new`` and ``hit``."""
    n_eval = ts.shape[0]
    karr = torch.arange(n_eval, device=ts.device)
    if t_new.dim():
        karr, ts = karr[:, None], ts[:, None]
    return ((karr >= eval_idx) & (karr < n_eval - 1)
            & ((ts <= t_new) | hit))


def natural_grid_outputs(ts, t, t_new, h_use, accept, hit, eval_idx, ys,
                         z, z_next, k0, k1, z_mid):
    """One trial's output writes in natural-grid (``interpolate_ts``) mode,
    solo (0-d ``t``; (n_eval, ...) ``ys``) or batched ((B,) times, masks
    and ``eval_idx``; (n_eval, B, ...) ``ys``): the interior eval times the
    accepted interval covers (``covered_evals``) take its interpolant's
    value; ``ts[-1]`` stays an exact landing. Returns (ys, coeffs, n_cov):
    the fitted interpolant and the interior-cover count ((B,) when
    batched); a masked no-op for a rejected trial."""
    n_eval = ts.shape[0]
    covered = covered_evals(ts, eval_idx, t_new, hit) & accept
    coeffs = interp_fit(z, z_next, k0, k1, h_use, z_mid)
    yint = interp_eval(coeffs, eval_theta(ts, t, h_use))

    def write(ys, yint, z_next):
        m = covered.reshape(tuple(covered.shape)
                            + (1,) * (ys.dim() - covered.dim()))
        ys = torch.where(m, yint, ys)
        last = _bwhere(hit, z_next, ys[n_eval - 1]) if t.dim() else \
            torch.where(hit, z_next, ys[n_eval - 1])
        return torch.cat([ys[:n_eval - 1], last.unsqueeze(0)])

    ys = gmap(write, ys, yint, z_next)
    return ys, coeffs, covered.sum(dim=0, dtype=torch.int64)


def trial_decision(cfg: ControllerConfig, order: int, t, h_use, h_min,
                   t_target, ratio, prev_ratio, tiny, one, big_ratio,
                   no_fault, guard_nonfinite: bool, live=None):
    """One trial's controller decision, shared by the four adaptive
    engines (solo and batched, RK and MALI): only the stepper call and the
    carry update differ between them.

    Takes the trial's clamped stepsize ``h_use`` (floor ``h_min``) and its
    error ``ratio``; ``live`` (B,) masks a batched trial's dead rows and
    ``no_fault`` is the all-False mask of ``bad`` with the guard off.
    Returns (accept, fail, uflow, t_new, hit, h_next): forced-minimum
    (railed) steps are accepted, as they cannot shrink, unless the guard
    finds the ratio non-finite; railed and still non-finite fails the
    solve (or row); a forced accept that still fails the error test is an
    underflow; ``hit`` an accepted step landing on ``t_target``.
    """
    railed = h_use <= h_min * (1 + 1e-3)
    accept = (ratio <= 1.0) | railed
    if guard_nonfinite:
        accept, bad = nonfinite_guard(ratio, accept)
    else:
        bad = no_fault
    fail = bad & railed
    if live is not None:
        accept = live & accept
        fail = live & fail
    uflow = accept & railed & (ratio > 1.0)

    t_new = t + h_use
    hit = accept & (t_new >= t_target - 16.0 * tiny * torch.maximum(
        torch.abs(t_target), one))
    # a non-finite ratio would poison the h chain; treat it as "error way
    # too large" so the retry shrinks at max rate
    ratio_c = torch.where(bad, big_ratio, ratio)
    h_next = propose_stepsize(cfg, h_use, ratio_c, prev_ratio,
                              order).to(t_new.dtype)
    return accept, fail, uflow, t_new, hit, h_next


def nonfinite_guard(ratio, accept):
    """The non-finite guard's work in a trial's decision, all of it:
    (``accept`` and a finite ``ratio``, ``bad`` where it is not finite).
    One read guards the whole trial: a NaN/Inf anywhere in the stage sums
    poisons the embedded error, and an Inf state makes the scaled norm
    Inf/Inf = NaN. The ratio is a norm, >= 0 or NaN, so ``ratio < inf``
    is False exactly where it is not finite: one tensor op where
    ``torch.isfinite`` dispatches four."""
    ok = ratio < math.inf
    return accept & ok, ~ok


def nonfinite_any(*states, group=None) -> torch.Tensor:
    """0-d bool: any of ``states`` (tensors or dtype groups) holds a NaN or
    Inf; on any rank of ``group`` (a ``SolveGroup``) where given."""
    out = None
    for x in (g for z in states for g in gleaves(z)):
        flag = torch.any(~torch.isfinite(x))
        out = flag if out is None else out | flag
    return out if group is None else group.any(out)


def nonfinite_rows(*states) -> torch.Tensor:
    """(B,) bool: row b of any of the batch-leading ``states`` (tensors or
    dtype groups) holds a NaN or Inf."""
    out = None
    for x in (g for z in states for g in gleaves(z)):
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


def _freeze_fill(ys, mask: torch.Tensor, z_frozen):
    """Repeat a failed solve's last accepted state into its un-reached
    eval slots (``mask`` (n_eval,), or (n_eval, B) with ``z_frozen``
    (B, ...) when batched); a bitwise no-op where it is False."""
    def fill(y, z):
        m = mask.reshape(mask.shape + (1,) * (y.dim() - mask.dim()))
        return torch.where(m, z.unsqueeze(0), y)

    return gmap(fill, ys, z_frozen)


def _write_hit(ys, eval_idx: torch.Tensor, hit: torch.Tensor,
               z_next) -> None:
    """Solo landing write, in place: ``ys[eval_idx]`` takes ``z_next``
    where ``hit``, else keeps its value."""
    for y, z in zip(gleaves(ys), gleaves(z_next)):
        cur = y.index_select(0, eval_idx)
        y.index_copy_(0, eval_idx, torch.where(hit, z.unsqueeze(0), cur))


def mask_failed_cotangents(g_ys: torch.Tensor, status: torch.Tensor,
                           batched: bool = False) -> torch.Tensor:
    """Zero the output cotangents of a solve (or of the batch rows, ``g_ys``
    (n_eval, B, ...)) whose status is ``NONFINITE_STATE``: a frozen
    solve's outputs are placeholders and carry no gradient. Every backward
    sweep is linear in ``g_ys``, so the failed rows get exact zeros and the
    others keep their bits."""
    ok = status != SolveStatus.NONFINITE_STATE
    if batched:
        ok = ok.reshape((1, -1) + (1,) * (g_ys.dim() - 2))
    return torch.where(ok, g_ys, torch.zeros_like(g_ys))


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
    checkpoint: bool = True,
    checkpoint_segments: Optional[int] = None,
    interpolate_ts: bool = False,
    store_coeffs: bool = False,
    group=None,
) -> Tuple[torch.Tensor, Optional[Checkpoints], SolveStats]:
    """Integrate dz/dt = f(t, z, *args) through increasing times ``ts``.

    Returns (ys, checkpoints, stats); ``ys`` is stacked over len(ts) with
    ys[0] = z0. Runs without autograd: the ACA Function differentiates it
    by replaying the checkpoints. ``use_pallas`` selects the fused flat
    stepper path (callers pass an already-flat (N,) state).
    ``checkpoint=False`` keeps no per-step buffer and returns None for
    the checkpoints (the adjoint method's O(N_f) forward).

    ``guard_nonfinite`` (default on): a trial whose error ratio is not
    finite is never accepted, and once the stepsize has railed at
    ``h_min`` with the trial still non-finite the solve freezes at its
    last accepted state with ``SolveStatus.NONFINITE_STATE``.

    ``checkpoint_segments=K`` (a resolved int, ``resolve_segmentation``)
    keeps K state snapshots and their k0 carries in place of every state;
    ``interpolate_ts`` runs the natural grid and ``store_coeffs`` (which
    implies it) keeps every step's interpolant; see the module docstring.
    The natural grid's bookkeeping stays on the device: the trial loop
    reads the host as often as in the landing mode.

    ``group`` (a ``distributed.regions.SolveGroup``): ``z0`` is this
    rank's block of a state split over the group's ranks; the error norm,
    the initial stepsize and the non-finite guard are the whole state's,
    so every rank takes the same trials (one all-reduce a trial).
    """
    if not tab.adaptive:
        raise ValueError("adaptive_while_solve requires an embedded "
                         "adaptive tableau")
    dev = gleaves(z0)[0].device
    n_eval = ts.shape[0]
    tdt = ts.dtype
    max_steps = cfg.max_steps
    # trial budget: every accepted step costs >= 1 trial
    max_total_trials = max_steps * cfg.max_trials
    n_snap, seg_len = _snapshot_layout(checkpoint_segments, max_steps)
    segmented = checkpoint_segments is not None
    natural = interpolate_ts or store_coeffs

    hinit_evals = 2 if h0 is None else 0  # hinit costs 2 f-evals
    if h0 is None:
        h0 = initial_stepsize(f, ts[0], z0, args, tab.order, rtol, atol,
                              group)
    h = torch.as_tensor(h0, dtype=tdt, device=dev).reshape(())

    ys = gzeros((n_eval,), z0)
    gset(ys, 0, z0)
    extra = {}
    if checkpoint:
        ckpt_t = torch.zeros(max_steps, dtype=tdt, device=dev)
        ckpt_h = torch.zeros_like(ckpt_t)
        ckpt_z = gzeros((n_snap,), z0)
        ckpt_oi = torch.full((max_steps,), -1, dtype=torch.int32,
                             device=dev)
        if natural:
            # each interval's half-open range of interpolated eval indices
            extra["ev_lo"] = torch.zeros(max_steps, dtype=torch.int32,
                                         device=dev)
            extra["ev_hi"] = torch.zeros_like(extra["ev_lo"])
        if store_coeffs:
            cf = [gzeros((max_steps,), z0) for _ in range(5)]

    k0 = f(ts[0], z0, *args)
    if checkpoint and segmented:
        # the k0 carry each snapshot's step consumed, for the re-chained
        # re-integration
        extra["k0"] = gzeros((n_snap,), k0)
    nfe = 1 + hinit_evals
    false = torch.zeros((), dtype=torch.bool, device=dev)
    # a non-finite initial state / derivative / h0 fails before stepping
    failed = nonfinite_any(z0, k0, h, group=group) if guard_nonfinite \
        else false
    uflow = false

    t, z = ts[0], z0
    prev_ratio = torch.ones((), dtype=torch.float32, device=dev)
    i = 0                                   # accepted steps so far
    trials = 0
    eval_idx = torch.ones(1, dtype=torch.int64, device=dev)  # next ts[] to hit
    tiny = torch.full((), torch.finfo(tdt).eps, dtype=tdt, device=dev)
    one = torch.ones((), dtype=tdt, device=dev)
    big_ratio = torch.full((), 1e10, dtype=torch.float32, device=dev)
    karr = torch.arange(n_eval, device=dev)
    final_idx = torch.full((), n_eval - 1, dtype=torch.int32, device=dev)

    # host read 1 of 2 per trial: the loop condition
    cost_hooks.loop_enter("trial")      # a data-dependent trial loop
    while (i < max_steps and trials < max_total_trials
           and bool((eval_idx[0] < n_eval) & ~failed)):
        cost_hooks.trial(carry=(t, z, h))
        # the natural grid lands on the last eval time only
        t_target = ts[n_eval - 1] if natural else \
            ts.index_select(0, eval_idx).reshape(())
        # clamp the trial step to land exactly on the target eval time
        h_min = 16.0 * tiny * torch.maximum(torch.abs(t), one)
        h_use = torch.clamp(h, h_min, t_target - t)
        res = rk_step(tab, f, t, z, h_use, args, k0=k0,
                      use_pallas=use_pallas, err_scale=(rtol, atol),
                      dense=natural, group=group)
        nfe += tab.stages - 1

        # fused path: the scaled norm came out of the combine kernel
        ratio = res.err_ratio if res.err_ratio is not None else \
            error_ratio(res.err, z, res.z_next, rtol, atol, group)
        accept, fail, uflow_now, t_new, hit, h_next = trial_decision(
            cfg, tab.order, t, h_use, h_min, t_target, ratio, prev_ratio,
            tiny, one, big_ratio, false, guard_nonfinite)
        failed = failed | fail
        uflow = uflow | uflow_now
        trials += 1

        # host read 2 of 2 per trial: accept / reject
        if accept:
            # first-stage reuse: FSAL takes the accepted step's last
            # stage, other tableaus evaluate f at the new point (before
            # the outputs: on the natural grid it is the interpolant's
            # end derivative)
            if tab.fsal:
                k0_acc = res.k_last
            else:
                k0_acc = f(t_new, res.z_next, *args)
                nfe += 1
            if checkpoint:
                # write the trajectory checkpoint (t_i, h_i, z_i)
                ckpt_t[i] = t
                ckpt_h[i] = h_use
                if not segmented:
                    gset(ckpt_z, i, z)
                elif i % seg_len == 0:
                    # a segment starts: snapshot z and the k0 it consumed
                    gset(ckpt_z, min(i // seg_len, n_snap - 1), z)
                    gset(extra["k0"], min(i // seg_len, n_snap - 1), k0)
                ckpt_oi[i] = torch.where(
                    hit, final_idx if natural else eval_idx[0].int(), -1)
            if natural:
                ys, coeffs, n_cov = natural_grid_outputs(
                    ts, t, t_new, h_use, accept, hit, eval_idx[0], ys, z,
                    res.z_next, res.k_first, k0_acc, res.z_mid)
                if checkpoint:
                    extra["ev_lo"][i] = eval_idx[0]
                    extra["ev_hi"][i] = eval_idx[0] + n_cov
                    if store_coeffs:
                        for buf, c in zip(cf, coeffs):
                            gset(buf, i, c)
                eval_idx = eval_idx + n_cov + hit.to(torch.int64)
            else:
                # record the output at an eval-time hit
                _write_hit(ys, eval_idx, hit, res.z_next)
                eval_idx = eval_idx + hit.to(torch.int64)
            k0 = k0_acc
            t, z = t_new, res.z_next
            prev_ratio = torch.clamp(ratio, min=1e-10)
            i += 1
        h = h_next

    cost_hooks.loop_exit()
    overflow = eval_idx[0] < n_eval
    trials_out = torch.full((), trials >= max_total_trials, dtype=torch.bool,
                            device=dev)
    status = _compose_status(failed, uflow, ~overflow, trials_out)
    # frozen solve: repeat the last accepted state into un-reached slots
    ys_out = _freeze_fill(ys, failed & (karr >= eval_idx[0]), z)
    if checkpoint and store_coeffs:
        extra["coeffs"] = InterpCoeffs(*cf)
    ckpts = Checkpoints(t=ckpt_t, h=ckpt_h, z=ckpt_z, out_idx=ckpt_oi,
                        n=i, **extra) if checkpoint else None

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


def _bwhere(pred: torch.Tensor, a, b):
    """``torch.where`` with a (B,) predicate over batch-leading states."""
    return gmap(lambda x, y: torch.where(
        pred.reshape((-1,) + (1,) * (x.dim() - 1)), x, y), a, b)


def batched_initial_stepsize(f: Callable, ts: torch.Tensor, z0,
                             args: Tuple, order: int, rtol, atol
                             ) -> torch.Tensor:
    """(B,) Hairer initial stepsizes of the rows of ``z0``, vmapped over
    the rows and, where they are per row, over the tolerances ((B,)
    tensors) and the start times (a (B, T) ``ts``'s first column; a 1-D
    ``ts``'s ``ts[0]`` is shared)."""
    def dim(x):
        return 0 if isinstance(x, torch.Tensor) and x.dim() > 0 else None

    t0 = ts[..., 0]
    return vmap(lambda z, t, rt, at: initial_stepsize(
        f, t, z, args, order, rt, at),
        in_dims=(0, dim(t0), dim(rtol), dim(atol)))(z0, t0, rtol, atol)


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
    checkpoint: bool = True,
    checkpoint_segments: Optional[int] = None,
    interpolate_ts: bool = False,
) -> Tuple[torch.Tensor, Optional[Checkpoints], SolveStats]:
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
    ``checkpoint`` as in ``adaptive_while_solve``.

    ``ts`` is (T,), shared by every row, or (B, T): row b starts at
    ``ts[b, 0]`` and lands on its own eval times ``ts[b]`` (the
    counterpart of ``vmap`` over per-sample eval times).

    ``checkpoint_segments`` as in ``adaptive_while_solve``, every row
    writing its own K snapshots at its own segment starts;
    ``interpolate_ts`` as there, every row on its own natural grid with
    its own ``ev_lo``/``ev_hi`` rows (a 1-D ``ts`` only).
    """
    if not tab.adaptive:
        raise ValueError("batched_adaptive_while_solve requires an "
                         "embedded adaptive tableau")
    if interpolate_ts and ts.dim() != 1:
        raise ValueError("interpolate_ts reads every row off one shared "
                         "1-D ts; per-row (B, T) ts are not supported")
    dev = gleaves(z0)[0].device
    B = gleaves(z0)[0].shape[0]
    rows = torch.arange(B, device=dev)
    n_eval = ts.shape[-1]
    ts_rows = ts.expand(B, n_eval)
    tdt = ts.dtype
    max_steps = cfg.max_steps
    max_total_trials = max_steps * cfg.max_trials
    n_snap, seg_len = _snapshot_layout(checkpoint_segments, max_steps)
    segmented = checkpoint_segments is not None

    row_tol = _row_tolerances(rtol, atol, B, dev)
    if row_tol is not None:
        rtol, atol = row_tol
    hinit_evals = 2 if h0 is None else 0  # hinit costs 2 f-evals per row
    if h0 is None:
        h0 = batched_initial_stepsize(f, ts, z0, args, tab.order, rtol, atol)
    h = torch.as_tensor(h0, dtype=tdt, device=dev).broadcast_to((B,)).clone()

    ys = gzeros((n_eval,), z0)
    gset(ys, 0, z0)
    extra = {}
    if checkpoint:
        ckpt_t = torch.zeros((B, max_steps), dtype=tdt, device=dev)
        ckpt_h = torch.zeros_like(ckpt_t)
        ckpt_z = gzeros((B, n_snap), z0, keep=1)
        ckpt_oi = torch.full((B, max_steps), -1, dtype=torch.int32,
                             device=dev)
        if interpolate_ts:
            extra["ev_lo"] = torch.zeros((B, max_steps), dtype=torch.int32,
                                         device=dev)
            extra["ev_hi"] = torch.zeros_like(extra["ev_lo"])

    fb = batched_field(f, args)
    t = ts_rows[:, 0].clone()
    k0 = fb(t, z0)
    if checkpoint and segmented:
        extra["k0"] = gzeros((B, n_snap), k0, keep=1)
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
    final_idx = torch.full((), n_eval - 1, dtype=torch.int32, device=dev)
    karr = torch.arange(n_eval, device=dev)
    no_fault = torch.zeros(B, dtype=torch.bool, device=dev)

    def live_mask():
        return ((eval_idx < n_eval) & (i < max_steps)
                & (trials < max_total_trials) & ~failed)

    live = live_mask()
    # the one host read per trial: any row still live (the while_loop's
    # cond)
    cost_hooks.loop_enter("trial-batched")  # a data-dependent trial loop
    while live.any():
        cost_hooks.trial(carry=(t, z, h))
        # the natural grid lands on the last eval time only
        t_target = ts[n_eval - 1].expand(B) if interpolate_ts else \
            ts_rows[rows, eval_idx.clamp(max=n_eval - 1)]       # (B,)
        h_min = 16.0 * tiny * torch.maximum(torch.abs(t), one)
        # dead rows step with h = 0: ψ degenerates to the identity
        h_use = torch.where(live, torch.clamp(h, h_min, t_target - t),
                            zero_h)
        res = rk_step_batched(tab, f, t, z, h_use, args, k0=k0,
                              use_pallas=use_pallas, err_scale=(rtol, atol),
                              dense=interpolate_ts)
        ratio = res.err_ratio                                   # (B,)
        # per-row stepsize control; a non-finite ratio shrinks at the
        # maximum rate instead of entering the h chain
        accept, fail_now, uflow_now, t_new, hit, h_next = trial_decision(
            cfg, tab.order, t, h_use, h_min, t_target, ratio, prev_ratio,
            tiny, one, big_ratio, no_fault, guard_nonfinite, live)

        # first-stage reuse per row: FSAL takes the last stage, other
        # tableaus evaluate f at every row's new point (a live row that
        # rejected discards it, as the reference's while_loop body does)
        if tab.fsal:
            k0_acc, nfe_acc = res.k_last, 0
        else:
            k0_acc, nfe_acc = fb(t_new, res.z_next), 1

        i_c = i.clamp(max=max_steps - 1).long()
        if checkpoint:
            # on accept: write each row's own checkpoint slot
            ckpt_t[rows, i_c] = torch.where(accept, t, ckpt_t[rows, i_c])
            ckpt_h[rows, i_c] = torch.where(accept, h_use,
                                            ckpt_h[rows, i_c])
            if not segmented:
                gset(ckpt_z, (rows, i_c),
                     _bwhere(accept, z, gget(ckpt_z, (rows, i_c))))
            else:
                # each row snapshots (z, the k0 it consumed) at its own
                # segment starts
                s = (i_c // seg_len).clamp(max=n_snap - 1)
                snap = accept & (i_c % seg_len == 0)
                gset(ckpt_z, (rows, s),
                     _bwhere(snap, z, gget(ckpt_z, (rows, s))))
                gset(extra["k0"], (rows, s),
                     _bwhere(snap, k0, gget(extra["k0"], (rows, s))))
            oi_val = torch.where(
                hit, final_idx if interpolate_ts else
                eval_idx.to(torch.int32), minus_one)
            ckpt_oi[rows, i_c] = torch.where(accept, oi_val,
                                             ckpt_oi[rows, i_c])
        if interpolate_ts:
            # each row reads the eval times its interval covers off its
            # own interpolant
            ys, _, n_cov = natural_grid_outputs(
                ts, t, t_new, h_use, accept, hit, eval_idx, ys, z,
                res.z_next, res.k_first, k0_acc, res.z_mid)
            if checkpoint:
                for key, v in (("ev_lo", eval_idx), ("ev_hi",
                                                     eval_idx + n_cov)):
                    buf = extra[key]
                    buf[rows, i_c] = torch.where(accept, v.to(torch.int32),
                                                 buf[rows, i_c])
            eval_adv = n_cov + hit.to(torch.int64)
        else:
            # on an eval-time hit: record that row's output
            e_c = eval_idx.clamp(max=n_eval - 1)
            gset(ys, (e_c, rows),
                 _bwhere(hit, res.z_next, gget(ys, (e_c, rows))))
            eval_adv = hit.to(torch.int64)

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
        eval_idx = eval_idx + eval_adv
        trials = trials + live.to(torch.int32)
        failed = failed | fail_now
        uflow = uflow | uflow_now
        live = live_mask()

    cost_hooks.loop_exit()
    overflow = eval_idx < n_eval
    status = _compose_status(failed, uflow, ~overflow,
                             trials >= max_total_trials)
    fill = failed[None, :] & (karr[:, None] >= eval_idx[None, :])
    ys_out = _freeze_fill(ys, fill, z)
    ckpts = Checkpoints(t=ckpt_t, h=ckpt_h, z=ckpt_z, out_idx=ckpt_oi,
                        n=i, **extra) if checkpoint else None
    stats = SolveStats(n_steps=i, n_trials=trials, nfe=nfe,
                       overflow=overflow, status=status)
    return ys_out, ckpts, stats


# ------------------------------------------------------------- fixed grids

def make_fixed_grid(ts: torch.Tensor, steps_per_interval: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform sub-grid with ``steps_per_interval`` steps between each
    pair of eval times: (t_grid, h_grid), each (n_intervals * steps,)."""
    t_lo, t_hi = ts[:-1], ts[1:]
    frac = torch.arange(steps_per_interval, device=ts.device).to(
        ts.dtype) / steps_per_interval
    t_grid = t_lo[:, None] + (t_hi - t_lo)[:, None] * frac[None, :]
    h_grid = ((t_hi - t_lo) / steps_per_interval)[:, None].expand(
        t_grid.shape)
    return t_grid.reshape(-1), h_grid.reshape(-1)


def fixed_status(ys) -> torch.Tensor:
    """A fixed grid has no trial loop to guard: one finite check of the
    outputs after the solve gives its ``SolveStatus``."""
    return torch.where(nonfinite_any(gdetach(ys)),
                       SolveStatus.NONFINITE_STATE,
                       SolveStatus.OK).to(torch.int32)


def fixed_stats(tab: Tableau, n_steps: int, status: torch.Tensor
                ) -> SolveStats:
    """``SolveStats`` of a fixed-grid solve of ``n_steps`` steps."""
    def count(v):
        return torch.full((), v, dtype=torch.int32, device=status.device)

    return SolveStats(n_steps=count(n_steps), n_trials=count(n_steps),
                      nfe=count(n_steps * tab.stages),
                      overflow=torch.zeros((), dtype=torch.bool,
                                           device=status.device),
                      status=status)


def fixed_grid_solve(
    tab: Tableau,
    f: Callable,
    z0,
    ts: torch.Tensor,
    args: Tuple,
    steps_per_interval: int,
    use_pallas: bool = False,
):
    """Integration on the uniform grid of ``make_fixed_grid``, outputs at
    every ``ts`` (ys[0] = z0); returns (ys, stats).

    Runs under the caller's autograd mode: differentiated, it is the
    naive method for fixed-step solvers (every stage on the tape).
    ``use_pallas`` ravels the state once (``stepper.maybe_flatten``) and
    runs every stage argument and the ``b`` combine through K1; a pytree
    state is raveled on either path and unraveled in ``ys``.
    """
    f, z0, unravel, use_pallas = maybe_flatten(f, z0, use_pallas)
    t_grid, h_grid = make_fixed_grid(ts, steps_per_interval)
    z = z0
    ys = [z0]
    cost_hooks.loop_enter("fixed-grid", dynamic=False)
    for j in range(t_grid.shape[0]):
        cost_hooks.trial(carry=(z,))
        z = rk_step(tab, f, t_grid[j], z, h_grid[j], args,
                    use_pallas=use_pallas).z_next
        if (j + 1) % steps_per_interval == 0:
            ys.append(z)
    cost_hooks.loop_exit()
    ys = gstack(ys)
    stats = fixed_stats(tab, t_grid.shape[0], fixed_status(ys))
    return (ys if unravel is None else unravel(ys)), stats


# ------------------------------------------------------------ MALI engines

class MaliGrid(NamedTuple):
    """The MALI solve's record for its backward: scalars and one pair.

    ``t``/``h``/``out_idx`` are the accepted scalar grid (the
    ``Checkpoints`` conventions: interval start, stepsize, eval index its
    end landed on or -1; slots [0, n) valid), ``zT``/``vT`` the terminal
    lattice pair the backward inverts from and ``scale_exp`` the lattice
    exponent, so the backward decodes on the same quantum. ``n`` is a host
    int solo; batched, the grids are (B, max_steps), ``n`` and
    ``scale_exp`` (B,) and the pair batch-leading: every row on its own
    lattice, as a solo solve of it would be.
    """
    t: torch.Tensor           # (max_steps,) interval start times
    h: torch.Tensor           # (max_steps,) accepted stepsizes
    out_idx: torch.Tensor     # (max_steps,) int32 eval landing (or -1)
    n: Union[int, torch.Tensor]
    zT: torch.Tensor          # terminal position, integer lattice
    vT: torch.Tensor          # terminal velocity, integer lattice
    scale_exp: torch.Tensor   # lattice scale exponent (f32)


@torch.no_grad()
def mali_adaptive_solve(
    f: Callable,
    z0: torch.Tensor,
    ts: torch.Tensor,
    args: Tuple,
    rtol: float,
    atol: float,
    cfg: ControllerConfig,
    h0: Optional[torch.Tensor] = None,
    guard_nonfinite: bool = True,
    group=None,
) -> Tuple[torch.Tensor, MaliGrid, SolveStats]:
    """Adaptive asynchronous-leapfrog solve through increasing ``ts``.

    The trial loop of ``adaptive_while_solve`` (two host reads a trial:
    the loop condition and the accept decision) on the lattice pair of
    ``stepper.alf_step``, whose embedded error is the Euler-comparator gap
    h·(w − v): one evaluation of f a trial, accepted or not (+1 for v0 =
    f(t0, z0), +2 for the initial-stepsize heuristic). Keeps no state per
    step, only the scalar grid. Returns (ys, grid, stats); ``ys[0]`` is z0
    itself, the later outputs the decoded lattice states (within one
    quantum of the float trajectory).

    ``guard_nonfinite``: the lattice encode turns a NaN into finite
    integers, so the decoded state cannot show it; the error ratio, made
    from the raw field evaluation, does, and is the guard. A trial whose
    ratio is not finite is rejected, and one that stays so at ``h_min``
    freezes the solve with ``SolveStatus.NONFINITE_STATE``.

    ``group``: as in ``adaptive_while_solve`` (the lattice's scale too is
    the whole state's).
    """
    dev = gleaves(z0)[0].device
    n_eval = ts.shape[0]
    tdt = ts.dtype
    max_steps = cfg.max_steps
    max_total_trials = max_steps * cfg.max_trials

    v0 = f(ts[0], z0, *args)
    scale_exp = alf_lattice_exponent(z0, v0, group)
    zq, vq = lattice_encode(z0, scale_exp), lattice_encode(v0, scale_exp)

    hinit_evals = 2 if h0 is None else 0  # hinit costs 2 f-evals
    if h0 is None:
        h0 = initial_stepsize(f, ts[0], z0, args, ALF_ORDER, rtol, atol,
                              group)
    h = torch.as_tensor(h0, dtype=tdt, device=dev).reshape(())

    ys = gzeros((n_eval,), z0)
    gset(ys, 0, z0)
    grid_t = torch.zeros(max_steps, dtype=tdt, device=dev)
    grid_h = torch.zeros_like(grid_t)
    grid_oi = torch.full((max_steps,), -1, dtype=torch.int32, device=dev)

    false = torch.zeros((), dtype=torch.bool, device=dev)
    failed = nonfinite_any(z0, v0, h, group=group) if guard_nonfinite \
        else false
    uflow = false
    nfe = 1 + hinit_evals                   # + the v0 evaluation
    t = ts[0]
    z = lattice_decode(zq, scale_exp, z0)   # the carry's decoded state
    prev_ratio = torch.ones((), dtype=torch.float32, device=dev)
    i = 0
    trials = 0
    eval_idx = torch.ones(1, dtype=torch.int64, device=dev)
    tiny = torch.full((), torch.finfo(tdt).eps, dtype=tdt, device=dev)
    one = torch.ones((), dtype=tdt, device=dev)
    big_ratio = torch.full((), 1e10, dtype=torch.float32, device=dev)
    karr = torch.arange(n_eval, device=dev)

    # host read 1 of 2 per trial: the loop condition
    cost_hooks.loop_enter("mali-trial")  # a data-dependent trial loop
    while (i < max_steps and trials < max_total_trials
           and bool((eval_idx[0] < n_eval) & ~failed)):
        cost_hooks.trial(carry=(t, zq, vq, h))
        t_target = ts.index_select(0, eval_idx).reshape(())
        h_min = 16.0 * tiny * torch.maximum(torch.abs(t), one)
        h_use = torch.clamp(h, h_min, t_target - t)
        res = alf_step(f, t, h_use, zq, vq, scale_exp, z0, args)
        nfe += 1                            # one midpoint evaluation
        ratio = error_ratio(res.err, z, res.z_next, rtol, atol, group)
        accept, fail, uflow_now, t_new, hit, h_next = trial_decision(
            cfg, ALF_ORDER, t, h_use, h_min, t_target, ratio, prev_ratio,
            tiny, one, big_ratio, false, guard_nonfinite)
        failed = failed | fail
        uflow = uflow | uflow_now
        trials += 1

        # host read 2 of 2 per trial: accept / reject
        if accept:
            grid_t[i] = t
            grid_h[i] = h_use
            grid_oi[i] = torch.where(hit, eval_idx[0].int(), -1)
            _write_hit(ys, eval_idx, hit, res.z_next)
            eval_idx = eval_idx + hit.to(torch.int64)
            t, z = t_new, res.z_next
            zq, vq = res.zq_next, res.vq_next
            prev_ratio = torch.clamp(ratio, min=1e-10)
            i += 1
        h = h_next

    cost_hooks.loop_exit()
    overflow = eval_idx[0] < n_eval
    trials_out = torch.full((), trials >= max_total_trials, dtype=torch.bool,
                            device=dev)
    status = _compose_status(failed, uflow, ~overflow, trials_out)
    ys_out = _freeze_fill(ys, failed & (karr >= eval_idx[0]), z)
    grid = MaliGrid(t=grid_t, h=grid_h, out_idx=grid_oi, n=i, zT=zq, vT=vq,
                    scale_exp=scale_exp)

    def count(v):
        return torch.full((), v, dtype=torch.int32, device=dev)

    stats = SolveStats(n_steps=count(i), n_trials=count(trials),
                       nfe=count(nfe), overflow=overflow, status=status)
    return ys_out, grid, stats


@torch.no_grad()
def batched_mali_adaptive_solve(
    f: Callable,
    z0: torch.Tensor,
    ts: torch.Tensor,
    args: Tuple,
    rtol,
    atol,
    cfg: ControllerConfig,
    h0: Optional[torch.Tensor] = None,
    guard_nonfinite: bool = True,
) -> Tuple[torch.Tensor, MaliGrid, SolveStats]:
    """Per-sample batched MALI forward: one controller, one lattice and
    one scalar grid per row, one host read a trial (``any(live)``).

    Every trial steps all B rows (dead rows with h = 0) so each row's
    field sees the shapes it sees in the inverse sweep. Frozen rows differ
    from the RK engines': the h = 0 ALF step is not the identity in v, so
    rejected, finished and failed rows keep their pair by masking alone
    (an integer ``where`` keeps their bits). ``rtol``/``atol`` floats or
    (B,) tensors, ``h0`` a scalar or (B,), ``ts`` (T,) or (B, T), as in
    ``batched_adaptive_while_solve``.
    """
    dev = gleaves(z0)[0].device
    B = gleaves(z0)[0].shape[0]
    rows = torch.arange(B, device=dev)
    n_eval = ts.shape[-1]
    ts_rows = ts.expand(B, n_eval)
    tdt = ts.dtype
    max_steps = cfg.max_steps
    max_total_trials = max_steps * cfg.max_trials

    row_tol = _row_tolerances(rtol, atol, B, dev)
    if row_tol is not None:
        rtol, atol = row_tol
    t = ts_rows[:, 0].clone()
    v0 = batched_field(f, args)(t, z0)
    scale_exp = alf_lattice_exponent_batched(z0, v0)          # (B,)
    zq, vq = lattice_encode(z0, scale_exp), lattice_encode(v0, scale_exp)

    hinit_evals = 2 if h0 is None else 0  # hinit costs 2 f-evals per row
    if h0 is None:
        h0 = batched_initial_stepsize(f, ts, z0, args, ALF_ORDER, rtol, atol)
    h = torch.as_tensor(h0, dtype=tdt, device=dev).broadcast_to((B,)).clone()

    ys = gzeros((n_eval,), z0)
    gset(ys, 0, z0)
    grid_t = torch.zeros((B, max_steps), dtype=tdt, device=dev)
    grid_h = torch.zeros_like(grid_t)
    grid_oi = torch.full((B, max_steps), -1, dtype=torch.int32, device=dev)

    nfe = torch.full((B,), 1 + hinit_evals, dtype=torch.int32, device=dev)
    failed = nonfinite_rows(z0, v0, h) if guard_nonfinite else \
        torch.zeros(B, dtype=torch.bool, device=dev)
    uflow = torch.zeros(B, dtype=torch.bool, device=dev)
    z = lattice_decode(zq, scale_exp, z0)
    prev_ratio = torch.ones(B, dtype=torch.float32, device=dev)
    i = torch.zeros(B, dtype=torch.int32, device=dev)
    eval_idx = torch.ones(B, dtype=torch.int64, device=dev)
    trials = torch.zeros(B, dtype=torch.int32, device=dev)
    tiny = torch.full((), torch.finfo(tdt).eps, dtype=tdt, device=dev)
    one = torch.ones((), dtype=tdt, device=dev)
    zero_h = torch.zeros((), dtype=tdt, device=dev)
    big_ratio = torch.full((), 1e10, dtype=torch.float32, device=dev)
    minus_one = torch.full((), -1, dtype=torch.int32, device=dev)
    karr = torch.arange(n_eval, device=dev)
    no_fault = torch.zeros(B, dtype=torch.bool, device=dev)

    def live_mask():
        return ((eval_idx < n_eval) & (i < max_steps)
                & (trials < max_total_trials) & ~failed)

    live = live_mask()
    # the one host read per trial: any row still live
    cost_hooks.loop_enter("mali-trial-batched")  # a data-dependent trial loop
    while live.any():
        cost_hooks.trial(carry=(t, zq, vq, h))
        t_target = ts_rows[rows, eval_idx.clamp(max=n_eval - 1)]   # (B,)
        h_min = 16.0 * tiny * torch.maximum(torch.abs(t), one)
        h_use = torch.where(live, torch.clamp(h, h_min, t_target - t),
                            zero_h)
        res = alf_step_batched(f, t, h_use, zq, vq, scale_exp, z0, args)
        ratio = error_ratio_batched(res.err, z, res.z_next, rtol, atol)
        accept, fail_now, uflow_now, t_new, hit, h_next = trial_decision(
            cfg, ALF_ORDER, t, h_use, h_min, t_target, ratio, prev_ratio,
            tiny, one, big_ratio, no_fault, guard_nonfinite, live)

        # on accept: each row's scalar grid slot
        i_c = i.clamp(max=max_steps - 1).long()
        grid_t[rows, i_c] = torch.where(accept, t, grid_t[rows, i_c])
        grid_h[rows, i_c] = torch.where(accept, h_use, grid_h[rows, i_c])
        oi_val = torch.where(hit, eval_idx.to(torch.int32), minus_one)
        grid_oi[rows, i_c] = torch.where(accept, oi_val, grid_oi[rows, i_c])
        # on an eval-time hit: that row's decoded output
        e_c = eval_idx.clamp(max=n_eval - 1)
        gset(ys, (e_c, rows), _bwhere(hit, res.z_next, gget(ys, (e_c, rows))))

        t = torch.where(accept, t_new, t)
        zq = _bwhere(accept, res.zq_next, zq)
        vq = _bwhere(accept, res.vq_next, vq)
        z = _bwhere(accept, res.z_next, z)
        h = torch.where(live, h_next, h)
        prev_ratio = torch.where(accept, torch.clamp(ratio, min=1e-10),
                                 prev_ratio)
        i = i + accept.to(torch.int32)
        eval_idx = eval_idx + hit.to(torch.int64)
        trials = trials + live.to(torch.int32)
        nfe = nfe + live.to(torch.int32)    # one midpoint evaluation
        failed = failed | fail_now
        uflow = uflow | uflow_now
        live = live_mask()

    cost_hooks.loop_exit()
    overflow = eval_idx < n_eval
    status = _compose_status(failed, uflow, ~overflow,
                             trials >= max_total_trials)
    fill = failed[None, :] & (karr[:, None] >= eval_idx[None, :])
    ys_out = _freeze_fill(ys, fill, z)
    grid = MaliGrid(t=grid_t, h=grid_h, out_idx=grid_oi, n=i, zT=zq, vT=vq,
                    scale_exp=scale_exp)
    stats = SolveStats(n_steps=i, n_trials=trials, nfe=nfe,
                       overflow=overflow, status=status)
    return ys_out, grid, stats
