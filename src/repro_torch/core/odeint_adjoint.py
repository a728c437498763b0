"""The adjoint method of Chen et al. 2018 — the paper's primary baseline.

Port of ``repro/core/odeint_adjoint.py``. Memory O(N_f): the forward
solve keeps no per-step buffer (``checkpoint=False``), only the outputs;
the backward re-integrates the augmented system

    d/dt [ z̄, λ, ḡ ] = [ f(t, z̄),  -(∂f/∂z)ᵀλ,  -(∂f/∂θ)ᵀλ ]

in reverse time from (z(T), ∂J/∂z(T), 0), segment by segment between the
eval times, injecting each output's cotangent into λ at its ``ts[k]``
(paper Eqs. 6-8; λ = +∂J/∂z). Each evaluation of the augmented field is
one evaluation of f and one vector-Jacobian product over (z, the floating
args leaves) by ``torch.func.vjp``. The augmented state (z̄, λ, ḡ) is
raveled into one vector, so the reverse solve runs on the same engines and
kernels as the forward (K1/K2, or K3/K4/K5 per row when batched); where
its leaves mix dtypes (a bf16 state beside f32 args, or a mixed-dtype
state: λ takes z's groups, ḡ the args' dtypes) it ravels into dtype groups
and runs the plain stepper.

Because z̄(t) is a fresh solve backwards, it drifts from the forward
trajectory by the truncation error of Theorem 3.2: the systematic
gradient error that ACA removes. ḡ covers every floating tensor leaf of
``args`` whether or not it takes a gradient, as the reference's does, so
the reverse solve's error norm (and grid) is the reference's.

With a ``SolveGroup`` (``z0`` this rank's block of a state split over
ranks, the field issuing collectives of its own) each evaluation's
vector-Jacobian product runs on the autograd tape (``torch.autograd.
grad``: the field's DTensors do not run under ``torch.func``), the
parameters' cotangents come back whole-summed from the field, and the
reverse norm weighs every element of (z̄, λ, ḡ) by its share, so the
reverse grid is the whole state's on every rank.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch
from torch.func import vjp
from torch.utils import _pytree as pytree

from repro_torch.kernels import cost_hooks

from .controller import ControllerConfig
from .groups import gget, gleaves, gmap, ungroup
from .integrate import (
    adaptive_while_solve,
    as_tuple,
    batched_adaptive_while_solve,
    fixed_grid_solve,
    mask_failed_cotangents,
)
from .odeint_aca import _Problem as _AcaProblem
from .stepper import flatten_problem, maybe_flatten, maybe_flatten_batched
from .tableaus import Tableau


class _Problem(_AcaProblem):
    """ACA's problem record (a fixed grid where ``steps_per_interval`` is
    set) with the adjoint's solves."""

    def __init__(self, *a, batched: bool = False, **kw):
        super().__init__(*a, **kw)
        self.batched = batched

    @torch.no_grad()
    def solve(self, f, z0, ts, args, forward: bool):
        """(ys, stats) of one solve without autograd and without a
        checkpoint buffer: the forward solve (its state already flat where
        it should be; it takes ``h0``), or a reverse segment of the
        augmented pytree, raveled here."""
        if self.steps_per_interval is not None:
            return fixed_grid_solve(self.tab, f, z0, ts, args,
                                    self.steps_per_interval,
                                    use_pallas=self.use_pallas)
        up, unravel, group = self.use_pallas, None, self.group
        if not forward:
            flatten = maybe_flatten_batched if self.batched else \
                maybe_flatten
            if group is not None:
                group = _reverse_group(group, z0)
            f, z0, unravel, up = flatten(f, z0, up)
        engine = batched_adaptive_while_solve if self.batched else \
            adaptive_while_solve
        kw = {} if group is None else {"group": group}
        ys, _, stats = engine(self.tab, f, z0, ts, args, self.rtol,
                              self.atol, self.cfg,
                              h0=self.h0 if forward else None,
                              use_pallas=up, checkpoint=False,
                              interpolate_ts=forward and self.interpolate_ts,
                              **kw)
        return (ys if unravel is None else unravel(ys)), stats


def _reverse_group(group, aug):
    """The reverse solve's group: over every mesh dim, each element of
    the augmented state (z̄, λ, ḡ) weighted by its share (``SolveGroup.
    args_layout``), counted once."""
    z, lam, theta = aug
    share = group.state_share()
    layout = group.args_layout
    weights = (gmap(lambda x: torch.full_like(x, share), z),
               gmap(lambda x: torch.full_like(x, share), lam),
               tuple(torch.full_like(x, s) for x, (s, _) in
                     zip(theta, layout)))
    n_z = sum(x.numel() for x in gleaves(z))
    n_global = 2 * group.numel(n_z) + sum(n for _, n in layout)
    flat = flatten_problem(lambda *a: None, weights)[1]
    return group.weighted([w.float() for w in gleaves(flat)], n_global)


def _tape_vjp(fn: Callable, z, *theta):
    """``torch.func.vjp`` on the autograd tape: (fn(z, *θ), the pullback
    of a cotangent of its output), for a field ``torch.func`` cannot
    trace."""
    zs = gmap(lambda x: x.detach().requires_grad_(), z)
    ths = tuple(x.detach().requires_grad_() for x in theta)
    with torch.enable_grad():
        out = fn(zs, *ths)

    def pullback(cot):
        ins = gleaves(zs) + list(ths)
        grads = torch.autograd.grad(gleaves(out), ins, gleaves(cot),
                                    allow_unused=True)
        grads = [torch.zeros_like(x) if gr is None else gr
                 for x, gr in zip(ins, grads)]
        n = len(gleaves(zs))
        return (ungroup(grads[:n]), *grads[n:])

    return gmap(torch.Tensor.detach, out), pullback


def _aug_dynamics(f: Callable, args_of: Callable, on_tape: bool = False):
    """The reverse-time augmented field over s = -t: (z̄, λ, ḡ) ->
    (-f, (∂f/∂z)ᵀλ, (∂f/∂θ)ᵀλ), θ the floating args leaves. Per sample
    under the batched engine's vmap, so ḡ is per row there.
    ``on_tape`` takes each product by ``_tape_vjp``."""
    pull = _tape_vjp if on_tape else vjp

    def g(s, aug, *theta):
        z, lam, _ = aug
        t = -s
        fz, pullback = pull(lambda zz, *th: f(t, zz, *args_of(th)), z,
                            *theta)
        cots = pullback(lam)
        return (gmap(torch.neg, fz), cots[0], tuple(cots[1:]))

    return g


def _adjoint_backward(prob: _Problem, ys, ts, g_ys, arg_leaves: List,
                      needs: List[bool]):
    """Reverse sweep: (dL/dz0, [dL/d leaf], None where not needed)."""
    batched = prob.batched
    g_ys = gmap(lambda g: mask_failed_cotangents(g, prob.stats.status,
                                                 batched=batched), g_ys)
    floating = [i for i, a in enumerate(arg_leaves)
                if isinstance(a, torch.Tensor) and a.is_floating_point()]
    theta = tuple(arg_leaves[i].detach() for i in floating)

    def args_of(th):
        leaves = list(arg_leaves)
        for i, x in zip(floating, th):
            leaves[i] = x
        return prob.args(leaves)

    g = _aug_dynamics(prob.f, args_of, on_tape=prob.group is not None)
    rows = (gleaves(ys)[0].shape[1],) if batched else ()
    aug = (gget(ys, -1), gget(g_ys, -1),
           tuple(torch.zeros(rows + tuple(x.shape), dtype=x.dtype,
                             device=x.device) for x in theta))
    # per-row eval times ((B, T) ts) give per-row (B, 2) segments
    cost_hooks.loop_enter("adjoint-reverse", dynamic=False)
    for k in range(ts.shape[-1] - 2, -1, -1):
        cost_hooks.trial(carry=aug)
        s_seg = torch.stack([-ts[..., k + 1], -ts[..., k]], dim=-1)
        ys_seg, _ = prob.solve(g, aug, s_seg, theta, forward=False)
        z_k, lam, gargs = pytree.tree_map(lambda y: y[-1], ys_seg)
        aug = (z_k, gmap(lambda la, g: la + g, lam, gget(g_ys, k)), gargs)
    cost_hooks.loop_exit()
    _, lam, gargs = aug
    if batched:
        # args are shared by the rows: their cotangents add up
        gargs = tuple(x.sum(dim=0) for x in gargs)
    dargs: List[Optional[torch.Tensor]] = [None] * len(arg_leaves)
    for i, ga in zip(floating, gargs):
        if needs[i]:
            dargs[i] = ga
    return lam, dargs


class _AdjointSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, prob: _Problem, ts, *tensors):
        z0, arg_leaves = prob.split(tensors)
        ys, stats = prob.solve(prob.f, z0, ts, prob.args(arg_leaves),
                               forward=True)
        prob.stats = stats
        ctx.prob = prob
        # residuals: the outputs alone (z(T) and the other eval times)
        ctx.save_for_backward(*gleaves(ys))
        ctx.ts, ctx.arg_leaves = ts, arg_leaves
        return ys

    @staticmethod
    def backward(ctx, *g_ys):
        ys = ungroup(list(ctx.saved_tensors))
        prob = ctx.prob
        dz0, dargs = _adjoint_backward(
            prob, ys, ctx.ts, ungroup(list(g_ys)), list(ctx.arg_leaves),
            list(ctx.needs_input_grad[2 + prob.n_z:]))
        return (None, None, *gleaves(dz0), *dargs)


def _run(f, z0, ts, args, unravel, tab, rtol=None, atol=None, cfg=None,
         h0=None, use_pallas=False, steps_per_interval=None, batched=False,
         interpolate_ts=False, group=None):
    leaves, spec = pytree.tree_flatten(as_tuple(args))
    prob = _Problem(tab, f, rtol, atol, cfg, h0, use_pallas, spec,
                    steps_per_interval=steps_per_interval, batched=batched,
                    interpolate_ts=interpolate_ts, group=group)
    ys = _AdjointSolve.apply(prob, ts, *prob.inputs(z0, leaves))
    if unravel is not None:
        ys = unravel(ys)
    return ys, prob.stats


def _adaptive_only(solver: Tableau) -> None:
    if not solver.adaptive:
        raise ValueError("adjoint baseline expects an adaptive tableau; "
                         "fixed-grid adjoint == ANODE-style, see "
                         "odeint_adjoint_fixed")


def odeint_adjoint(
    f: Callable,
    z0: Any,
    ts: torch.Tensor,
    args: Any = (),
    *,
    solver: Tableau,
    rtol: float = 1e-6,
    atol: float = 1e-6,
    cfg: Optional[ControllerConfig] = None,
    h0: Optional[torch.Tensor] = None,
    use_pallas: bool = False,
    interpolate_ts: bool = False,
    group=None,
):
    """Adjoint-method odeint: O(N_f) memory, reverse-time numerical error.
    Returns (ys, stats) of the forward solve.

    ``h0`` overrides the forward solve's initial stepsize. A failed
    (``NONFINITE_STATE``) forward solve gets zero cotangents, so its
    gradients are exact zeros. ``use_pallas`` runs the forward solve on
    the raveled state and each backward segment on the raveled augmented
    state, both through K1/K2. ``interpolate_ts`` puts the forward solve
    on its natural grid; the backward is unchanged (the reverse solve
    injects each output's cotangent at its ``ts[k]`` as before).
    ``group`` (a ``distributed.regions.SolveGroup``): ``z0`` is this
    rank's block of a split state (see the module docstring).
    """
    if cfg is None:
        cfg = ControllerConfig()
    _adaptive_only(solver)
    f, z0, unravel, use_pallas = maybe_flatten(f, z0, use_pallas)
    return _run(f, z0, ts, args, unravel, solver, rtol, atol, cfg, h0,
                use_pallas, interpolate_ts=interpolate_ts, group=group)


def odeint_adjoint_batched(
    f: Callable,
    z0: Any,
    ts: torch.Tensor,
    args: Any = (),
    *,
    solver: Tableau,
    rtol=1e-6,
    atol=1e-6,
    cfg: Optional[ControllerConfig] = None,
    h0: Optional[torch.Tensor] = None,
    use_pallas: bool = False,
    interpolate_ts: bool = False,
):
    """Per-sample batched adjoint: ``odeint(..., batch_axis=0)``'s adjoint
    path.

    Forward: ``batched_adaptive_while_solve`` over the per-sample state,
    every row on its own grid, the outputs kept. Backward: each row's
    augmented system (z̄_b, λ_b, ḡ_b), raveled to one (B, N_aug) state,
    is solved in reverse by the same batched engine (K3 and K4/K5), each
    row on its own reverse grid; ḡ is carried per row and summed over the
    rows at the end. Returns (ys (len(ts), B, ...), stats with (B,)
    fields). ``rtol``/``atol`` may be (B,) tensors, used forward and back.
    ``interpolate_ts`` as in ``odeint_adjoint``.
    """
    if cfg is None:
        cfg = ControllerConfig()
    _adaptive_only(solver)
    f, z0, unravel, use_pallas = maybe_flatten_batched(f, z0, use_pallas)
    return _run(f, z0, ts, args, unravel, solver, rtol, atol, cfg, h0,
                use_pallas, batched=True, interpolate_ts=interpolate_ts)


def odeint_adjoint_fixed(
    f: Callable,
    z0: Any,
    ts: torch.Tensor,
    args: Any = (),
    *,
    solver: Tableau,
    steps_per_interval: int = 8,
    use_pallas: bool = False,
    group=None,
):
    """Fixed-grid adjoint (the ANODE-family baseline): the augmented system
    re-integrated in reverse on the same uniform grid, O(N_f) memory; the
    reverse z̄ still drifts from the forward one. Returns (ys, stats).
    ``group``: as in ``odeint_adjoint`` (a fixed grid reduces nothing;
    the field's products go on the tape)."""
    f, z0, unravel, use_pallas = maybe_flatten(f, z0, use_pallas)
    return _run(f, z0, ts, args, unravel, solver, use_pallas=use_pallas,
                steps_per_interval=steps_per_interval, group=group)
