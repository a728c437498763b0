"""Adaptive Checkpoint Adjoint (ACA) — the paper's contribution, in torch.

Port of ``repro/core/odeint_aca.py::odeint_aca``, ``odeint_aca_batched``
and their backward sweeps for the full checkpoint buffer.

Forward (paper Algorithm 2): integrate with ``adaptive_while_solve``
without autograd — the stepsize search never enters a graph — and keep
only the accepted points {t_i}, stepsizes {h_i} and states {z_i}.

Backward: λ starts at ∂J/∂z(T); walking the accepted steps in reverse,
each step re-takes ONE local ψ(t_i, z_i, h_i) with the saved stepsize
(no search) under ``enable_grad`` and back-propagates λ through it with
``torch.autograd.grad``, accumulating dJ/dargs. The local graph is freed
after each step. The replay retraces the forward trajectory exactly, so
the gradient is that of the numerical solution.

Batched (``odeint_aca_batched``): every row records its own grid and the
backward replays each row's grid in reverse, all rows in one batched ψ
per replayed step; a row shorter than the longest is frozen with h = 0.

Fixed grid (``odeint_aca_fixed``): the forward checkpoints every grid
state and the same backward sweep replays the grid — the naive fixed-grid
gradient, with {z_i} stored in place of every stage.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from .controller import ControllerConfig
from .integrate import (
    Checkpoints,
    SolveStats,
    adaptive_while_solve,
    as_tuple,
    batched_adaptive_while_solve,
    fixed_stats,
    fixed_status,
    make_fixed_grid,
    mask_failed_cotangents,
)
from .stepper import (
    maybe_flatten,
    maybe_flatten_batched,
    rk_step,
    rk_step_batched,
)
from .tableaus import Tableau


class _Problem:
    """What the autograd Function needs besides its tensor inputs."""

    def __init__(self, tab, f, rtol, atol, cfg, h0, use_pallas, args_spec,
                 steps_per_interval: Optional[int] = None):
        self.tab, self.f = tab, f
        self.rtol, self.atol, self.cfg, self.h0 = rtol, atol, cfg, h0
        self.use_pallas = use_pallas
        self.args_spec = args_spec
        # None: the adaptive engine; else the fixed grid's steps per
        # interval
        self.steps_per_interval = steps_per_interval
        self.stats: Optional[SolveStats] = None

    def args(self, leaves) -> Tuple:
        return as_tuple(pytree.tree_unflatten(list(leaves), self.args_spec))


def _diff_args(prob: _Problem, arg_leaves: List, needs: List[bool]):
    """(args for the replay, the leaves that take a gradient, their mask):
    leaves of args that take a gradient become fresh autograd leaves."""
    diff = [bool(nd) and isinstance(a, torch.Tensor)
            and a.is_floating_point() for a, nd in zip(arg_leaves, needs)]
    leaves = [a.detach().requires_grad_() if d else a
              for a, d in zip(arg_leaves, diff)]
    wrt_args = [a for a, d in zip(leaves, diff) if d]
    return prob.args(leaves), wrt_args, diff


def _aca_backward_sweep(tab: Tableau, f: Callable, ckpts: Checkpoints,
                        prob: _Problem, arg_leaves: List, needs: List[bool],
                        g_ys: torch.Tensor, use_pallas: bool):
    """Reverse sweep over the trajectory checkpoints.

    Returns (dL/dz0, [dL/d leaf] for every args leaf, None where ``needs``
    is False). ``g_ys[k]`` is injected into λ when the sweep crosses the
    endpoint that landed on eval time ts[k].
    """
    args, wrt_args, diff = _diff_args(prob, arg_leaves, needs)

    lam = torch.zeros_like(g_ys[0])
    gargs = [torch.zeros_like(a) for a in wrt_args]
    for i in range(ckpts.n - 1, -1, -1):
        t_i, h_i = ckpts.t[i], ckpts.h[i]
        oi = ckpts.out_idx[i]
        # inject the cotangent of an output landing on this interval's
        # endpoint: λ(t_{i+1}) += ∂J/∂y_k
        g_k = g_ys.index_select(0, oi.clamp(min=0).reshape(1).long())[0]
        lam = torch.where(oi >= 0, lam + g_k, lam)

        # local forward + local backward (paper Algorithm 2, backward pass):
        # one ψ with the SAVED stepsize; k0 is recomputed so its gradient
        # flows
        with torch.enable_grad():
            z_i = ckpts.z[i].detach().requires_grad_()
            z_next = rk_step(tab, f, t_i, z_i, h_i, args,
                             use_pallas=use_pallas).z_next
            grads = torch.autograd.grad(z_next, [z_i] + wrt_args, lam,
                                        allow_unused=True)
        lam = grads[0] if grads[0] is not None else torch.zeros_like(lam)
        gargs = [ga if d is None else ga + d
                 for ga, d in zip(gargs, grads[1:])]
    # cotangent of ys[0] = z0 (identity path)
    lam = lam + g_ys[0]
    out = iter(gargs)
    return lam, [next(out) if d else None for d in diff]


@torch.no_grad()
def _fixed_checkpoint_solve(tab: Tableau, f: Callable, z0: torch.Tensor,
                            ts: torch.Tensor, args: Tuple,
                            steps_per_interval: int, use_pallas: bool):
    """The fixed grid without autograd, every grid step's start state
    checkpointed: (ys, checkpoints, stats)."""
    t_grid, h_grid = make_fixed_grid(ts, steps_per_interval)
    n_steps = t_grid.shape[0]
    ckpt_z = torch.empty((n_steps,) + tuple(z0.shape), dtype=z0.dtype,
                         device=z0.device)
    ys = [z0]
    z = z0
    for j in range(n_steps):
        ckpt_z[j] = z
        z = rk_step(tab, f, t_grid[j], z, h_grid[j], args,
                    use_pallas=use_pallas).z_next
        if (j + 1) % steps_per_interval == 0:
            ys.append(z)
    ys = torch.stack(ys)
    # step j's endpoint lands on ts[(j + 1) / steps] at an interval's end
    j1 = torch.arange(1, n_steps + 1, device=z0.device)
    out_idx = torch.where(j1 % steps_per_interval == 0,
                          j1 // steps_per_interval, -1).to(torch.int32)
    ckpts = Checkpoints(t=t_grid, h=h_grid, z=ckpt_z, out_idx=out_idx,
                        n=n_steps)
    return ys, ckpts, fixed_stats(tab, n_steps, fixed_status(ys))


def _save_checkpoints(ctx, ckpts: Checkpoints) -> None:
    """Keep the trajectory checkpoint for the backward through
    ``save_for_backward``, where autograd's saved-tensor hooks see it."""
    ctx.save_for_backward(ckpts.t, ckpts.h, ckpts.z, ckpts.out_idx)
    ctx.n = ckpts.n


def _saved_checkpoints(ctx) -> Checkpoints:
    return Checkpoints(*ctx.saved_tensors, n=ctx.n)


class _AcaSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, prob: _Problem, z0, ts, *arg_leaves):
        args = prob.args(arg_leaves)
        if prob.steps_per_interval is None:
            ys, ckpts, stats = adaptive_while_solve(
                prob.tab, prob.f, z0, ts, args, prob.rtol, prob.atol,
                prob.cfg, h0=prob.h0, use_pallas=prob.use_pallas)
        else:
            ys, ckpts, stats = _fixed_checkpoint_solve(
                prob.tab, prob.f, z0, ts, args, prob.steps_per_interval,
                prob.use_pallas)
        prob.stats = stats
        ctx.prob = prob
        _save_checkpoints(ctx, ckpts)
        ctx.status = stats.status
        ctx.arg_leaves = arg_leaves
        return ys

    @staticmethod
    def backward(ctx, g_ys):
        prob = ctx.prob
        # a frozen (NONFINITE_STATE) solve's placeholder outputs carry no
        # gradient: zero the cotangents before the replay sweep
        g_ys = mask_failed_cotangents(g_ys, ctx.status)
        dz0, dargs = _aca_backward_sweep(prob.tab, prob.f,
                                         _saved_checkpoints(ctx), prob,
                                         list(ctx.arg_leaves),
                                         list(ctx.needs_input_grad[3:]),
                                         g_ys, prob.use_pallas)
        return (None, dz0, None, *dargs)


def _aca_backward_sweep_batched(tab: Tableau, f: Callable,
                                ckpts: Checkpoints, prob: _Problem,
                                arg_leaves: List, needs: List[bool],
                                g_ys: torch.Tensor, use_pallas: bool):
    """Per-row reverse sweep: each batch row replays its own grid.

    ``ckpts`` rows are per row (t/h/out_idx (B, S), z (B, S, ...), n
    (B,)); ``g_ys`` is (n_eval, B, ...). The sweep runs max(n) iterations;
    at iteration j row b replays its slot n_b - 1 - j, and once j >= n_b it
    replays slot 0 with h = 0, the identity in z with a zero cotangent for
    args, so its λ is untouched. Returns (dL/dz0 (B, ...), [dL/d leaf]
    summed over the rows, since args are shared).
    """
    args, wrt_args, diff = _diff_args(prob, arg_leaves, needs)
    n = ckpts.n
    B = n.shape[0]
    rows = torch.arange(B, device=n.device)
    zero_h = torch.zeros((), dtype=ckpts.h.dtype, device=n.device)
    minus_one = torch.full((), -1, dtype=ckpts.out_idx.dtype,
                           device=n.device)

    lam = torch.zeros_like(g_ys[0])
    gargs = [torch.zeros_like(a) for a in wrt_args]
    n_max = n.max()
    # the backward's one host read: the replay length max_b n_b
    for j in range(int(n_max)):
        i = n - 1 - j                        # (B,), negative when done
        live = i >= 0
        i_c = i.clamp(min=0).long()
        t_i = ckpts.t[rows, i_c]
        h_i = torch.where(live, ckpts.h[rows, i_c], zero_h)
        oi = torch.where(live, ckpts.out_idx[rows, i_c], minus_one)
        # inject each row's output cotangent where its interval's endpoint
        # landed on an eval time: λ_b(t_{i+1}) += ∂J/∂y_{oi_b}
        g_k = g_ys[oi.clamp(min=0).long(), rows]
        lam = torch.where((oi >= 0).reshape((-1,) + (1,) * (lam.dim() - 1)),
                          lam + g_k, lam)
        with torch.enable_grad():
            z_i = ckpts.z[rows, i_c].detach().requires_grad_()
            z_next = rk_step_batched(tab, f, t_i, z_i, h_i, args,
                                     use_pallas=use_pallas).z_next
            grads = torch.autograd.grad(z_next, [z_i] + wrt_args, lam,
                                        allow_unused=True)
        lam = grads[0] if grads[0] is not None else torch.zeros_like(lam)
        gargs = [ga if d is None else ga + d
                 for ga, d in zip(gargs, grads[1:])]
    # cotangent of ys[0] = z0 (identity path)
    lam = lam + g_ys[0]
    out = iter(gargs)
    return lam, [next(out) if d else None for d in diff]


class _AcaSolveBatched(torch.autograd.Function):
    @staticmethod
    def forward(ctx, prob: _Problem, z0, ts, *arg_leaves):
        args = prob.args(arg_leaves)
        ys, ckpts, stats = batched_adaptive_while_solve(
            prob.tab, prob.f, z0, ts, args, prob.rtol, prob.atol, prob.cfg,
            h0=prob.h0, use_pallas=prob.use_pallas)
        prob.stats = stats
        ctx.prob = prob
        _save_checkpoints(ctx, ckpts)
        ctx.status = stats.status
        ctx.arg_leaves = arg_leaves
        return ys

    @staticmethod
    def backward(ctx, g_ys):
        prob = ctx.prob
        # failed rows: their frozen placeholder outputs carry no gradient,
        # into neither their own dz0 nor the shared args
        g_ys = mask_failed_cotangents(g_ys, ctx.status, batched=True)
        dz0, dargs = _aca_backward_sweep_batched(
            prob.tab, prob.f, _saved_checkpoints(ctx), prob,
            list(ctx.arg_leaves),
            list(ctx.needs_input_grad[3:]), g_ys, prob.use_pallas)
        return (None, dz0, None, *dargs)


def odeint_aca_batched(
    f: Callable,
    z0: torch.Tensor,
    ts: torch.Tensor,
    args: Any = (),
    *,
    solver: Tableau,
    rtol=1e-6,
    atol=1e-6,
    cfg: Optional[ControllerConfig] = None,
    h0: Optional[torch.Tensor] = None,
    use_pallas: bool = False,
) -> Tuple[torch.Tensor, SolveStats]:
    """Per-sample batched ACA: ``odeint(..., batch_axis=0)``'s path.

    ``z0`` carries a leading batch dimension B and ``f`` is the
    per-sample field. Forward: ``batched_adaptive_while_solve``, every
    row on its own grid. Backward: each row's grid replayed in reverse
    (``_aca_backward_sweep_batched``), so every row's gradient is that of
    its own numerical solution. Returns (ys (len(ts), B, ...), stats with
    (B,) fields). ``rtol``/``atol`` are floats or (B,) tensors (per-row
    tolerances; no gradient); ``h0`` a scalar or (B,).
    """
    if cfg is None:
        cfg = ControllerConfig()
    if not solver.adaptive:
        raise ValueError(
            "odeint_aca_batched requires an embedded adaptive tableau; "
            "fixed grids batch losslessly through odeint_aca_fixed")
    f, z0, unravel, use_pallas = maybe_flatten_batched(f, z0, use_pallas)
    leaves, spec = pytree.tree_flatten(as_tuple(args))
    prob = _Problem(solver, f, rtol, atol, cfg, h0, use_pallas, spec)
    ys = _AcaSolveBatched.apply(prob, z0, ts, *leaves)
    if unravel is not None:
        ys = unravel(ys)
    return ys, prob.stats


def odeint_aca(
    f: Callable,
    z0: torch.Tensor,
    ts: torch.Tensor,
    args: Any = (),
    *,
    solver: Tableau,
    rtol: float = 1e-6,
    atol: float = 1e-6,
    cfg: Optional[ControllerConfig] = None,
    h0: Optional[torch.Tensor] = None,
    use_pallas: bool = False,
) -> Tuple[torch.Tensor, SolveStats]:
    """Solve dz/dt = f(t, z, *args) with ACA gradients.

    Returns (ys, stats) with ys stacked over ``ts`` (ys[0] = z0).
    Differentiable with respect to ``z0`` (a tensor, or a pytree of
    tensors of one floating dtype) and every floating tensor in ``args``
    (a tensor, or a tuple/list/dict nesting of tensors); ``ts`` is a
    constant, as in the paper. ``use_pallas`` flattens the state once per
    solve and runs the trial loop and the backward replay on the fused
    kernel path; the flatten and unflatten sit outside the autograd
    Function, so cotangents pass through them as reshapes.
    """
    if cfg is None:
        cfg = ControllerConfig()
    if not solver.adaptive:
        raise ValueError(
            "odeint_aca requires an embedded adaptive tableau; fixed grids "
            "take odeint_aca_fixed")
    f, z0, unravel, use_pallas = maybe_flatten(f, z0, use_pallas)
    leaves, spec = pytree.tree_flatten(as_tuple(args))
    prob = _Problem(solver, f, rtol, atol, cfg, h0, use_pallas, spec)
    ys = _AcaSolve.apply(prob, z0, ts, *leaves)
    if unravel is not None:
        ys = unravel(ys)
    return ys, prob.stats


def odeint_aca_fixed(
    f: Callable,
    z0,
    ts: torch.Tensor,
    args: Any = (),
    *,
    solver: Tableau,
    steps_per_interval: int = 8,
    use_pallas: bool = False,
):
    """Fixed-grid ACA: the forward checkpoints every grid state without
    autograd; the backward replays one ψ per grid step in reverse. The
    gradient is the naive fixed-grid one (the same discrete solution),
    storing {z_i} instead of every stage. Returns (ys, stats).
    """
    f, z0, unravel, use_pallas = maybe_flatten(f, z0, use_pallas)
    leaves, spec = pytree.tree_flatten(as_tuple(args))
    prob = _Problem(solver, f, None, None, None, None, use_pallas, spec,
                    steps_per_interval=steps_per_interval)
    ys = _AcaSolve.apply(prob, z0, ts, *leaves)
    if unravel is not None:
        ys = unravel(ys)
    return ys, prob.stats
