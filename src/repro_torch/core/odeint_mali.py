"""MALI: reversible asynchronous-leapfrog gradients in O(1) state memory.

Port of ``repro/core/odeint_mali.py`` (MALI, Zhuang et al. 2021), the
fourth gradient method.

Forward: ``integrate.mali_adaptive_solve`` integrates with the ALF pair
stepper (one field evaluation a trial, the RK engines' stepsize search)
without autograd, and keeps no state per step: only the accepted scalar
grid {t_i, h_i, out_idx_i} and the terminal lattice pair (z_N, v_N).
They reach the backward through ``save_for_backward``, where autograd's
saved-tensor hooks count them.

Backward: walking the grid in reverse, each accepted step is inverted
from the current pair (``stepper.alf_step_inverse``: the pair lives on an
integer lattice, so the reconstructed (z_i, v_i) is the forward's bit for
bit), then λ = (λ_z, λ_v) is pulled back through the float twin
``alf_step_float`` at the reconstructed pair with ``torch.autograd.grad``
(kernel K1, or K3 batched, for its two half-drifts under ``use_pallas``),
accumulating dJ/dargs; an output's cotangent enters λ_z where
``out_idx`` marks its landing. Last, v_0 = f(t_0, z_0) closes the sweep:
λ_v's remainder flows into z_0 and the args through f's pullback. Each
backward step costs one inverse step and one differentiated float step,
about three evaluations of f.

Batched (``odeint_mali_batched``): every row unwinds its own grid from its
own pair; a row with no step left is frozen by masking (its pair held,
its incoming cotangents zeroed before the pullback), since the h = 0 ALF
step is not the identity in v.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels import cost_hooks

from .controller import ControllerConfig
from .groups import gget, gleaves, gmap, ungroup
from .integrate import (
    MaliGrid,
    SolveStats,
    as_tuple,
    batched_mali_adaptive_solve,
    mali_adaptive_solve,
    mask_failed_cotangents,
)
from .odeint_aca import _diff_args, _Problem
from .stepper import (
    alf_step_float,
    alf_step_float_batched,
    alf_step_inverse,
    alf_step_inverse_batched,
    batched_field,
    lattice_decode,
    lattice_encode,
    maybe_flatten,
    maybe_flatten_batched,
)

_GRID = ("t", "h", "out_idx", "zT", "vT", "scale_exp")


class MaliSweep:
    """One inverting reverse sweep's state: the pair being unwound (``zq``,
    ``vq``; after ``mali_backward_sweep`` the reconstructed start pair),
    the adjoints and the args cotangent."""

    def __init__(self, prob: _Problem, grid: MaliGrid, z0,
                 ts: torch.Tensor, arg_leaves: List, needs: List[bool],
                 g_ys: torch.Tensor, batched: bool):
        self.prob, self.grid, self.z0, self.ts = prob, grid, z0, ts
        self.g_ys, self.batched = g_ys, batched
        self.args, self.wrt_args, self.diff = _diff_args(prob, arg_leaves,
                                                         needs)
        self.zq, self.vq = grid.zT, grid.vT
        self.lam_z = gmap(torch.zeros_like, gget(g_ys, 0))
        self.lam_v = gmap(torch.zeros_like, self.lam_z)
        self.gargs = [torch.zeros_like(a) for a in self.wrt_args]

    def _t0(self) -> torch.Tensor:
        """The start time: 0-d solo, (B,) batched."""
        t0 = self.ts[..., 0]
        if self.batched and t0.dim() == 0:
            t0 = t0.expand(gleaves(self.z0)[0].shape[0])
        return t0

    def _field0(self, z0):
        if self.batched:
            return batched_field(self.prob.f, self.args)(self._t0(), z0)
        return self.prob.f(self._t0(), z0, *self.args)

    @torch.no_grad()
    def encoded_start(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The forward's start pair (lattice_encode of z0 and of v0 =
        f(t0, z0)), recomputed: what the sweep must reconstruct bit for
        bit."""
        se = self.grid.scale_exp
        return (lattice_encode(self.z0, se),
                lattice_encode(self._field0(self.z0), se))

    def _pull(self, t_i, h_i, z_p, v_p, cot_z, cot_v):
        """(dz, dv) of the float twin at (z_p, v_p) against (cot_z, cot_v),
        adding its args cotangent into ``gargs``."""
        step = alf_step_float_batched if self.batched else alf_step_float
        with torch.enable_grad():
            z_p = gmap(lambda x: x.detach().requires_grad_(), z_p)
            v_p = gmap(lambda x: x.detach().requires_grad_(), v_p)
            z_n, v_n = step(self.prob.f, t_i, h_i, z_p, v_p, self.args,
                            use_pallas=self.prob.use_pallas)
            ins = gleaves(z_p) + gleaves(v_p)
            grads = torch.autograd.grad(gleaves(z_n) + gleaves(v_n),
                                        ins + self.wrt_args,
                                        gleaves(cot_z) + gleaves(cot_v),
                                        allow_unused=True)
        self._add_args(grads[len(ins):])
        d = [g if g is not None else torch.zeros_like(x)
             for g, x in zip(grads, ins)]
        n_z = len(gleaves(z_p))
        return ungroup(d[:n_z]), ungroup(d[n_z:])

    def _add_args(self, grads) -> None:
        self.gargs = [ga if d is None else ga + d
                      for ga, d in zip(self.gargs, grads)]

    def step(self, i: int) -> None:
        """Solo: inject the output cotangent landing at step ``i``'s end,
        invert step ``i`` and pull λ back through it."""
        g, se = self.grid, self.grid.scale_exp
        t_i, h_i, oi = g.t[i], g.h[i], g.out_idx[i]
        g_k = gmap(lambda g: g.index_select(
            0, oi.clamp(min=0).reshape(1).long())[0], self.g_ys)
        lam_z = gmap(lambda la, gk: torch.where(oi >= 0, la + gk, la),
                     self.lam_z, g_k)
        with torch.no_grad():
            self.zq, self.vq = alf_step_inverse(
                self.prob.f, t_i, h_i, self.zq, self.vq, se, self.z0,
                self.args)
        z_p = lattice_decode(self.zq, se, self.z0)
        v_p = lattice_decode(self.vq, se, self.z0)
        self.lam_z, self.lam_v = self._pull(t_i, h_i, z_p, v_p, lam_z,
                                            self.lam_v)

    def step_batched(self, j: int) -> None:
        """Batched iteration ``j``: row b inverts its step n_b − 1 − j; a
        row with none left keeps its pair and λ and adds exact zeros to
        the args cotangent."""
        g, se = self.grid, self.grid.scale_exp
        rows = torch.arange(g.n.shape[0], device=g.n.device)
        i = g.n - 1 - j                              # (B,), < 0 when done
        live = i >= 0
        i_c = i.clamp(min=0).long()
        t_i = g.t[rows, i_c]
        h_i = torch.where(live, g.h[rows, i_c], torch.zeros_like(t_i))
        oi = torch.where(live, g.out_idx[rows, i_c],
                         torch.full_like(g.out_idx[rows, i_c], -1))
        g_k = gget(self.g_ys, (oi.clamp(min=0).long(), rows))
        lam_z = _rwhere(oi >= 0, gmap(lambda la, gk: la + gk, self.lam_z,
                                      g_k), self.lam_z)
        with torch.no_grad():
            inv_z, inv_v = alf_step_inverse_batched(
                self.prob.f, t_i, h_i, self.zq, self.vq, se, self.z0,
                self.args)
        self.zq = _rwhere(live, inv_z, self.zq)
        self.vq = _rwhere(live, inv_v, self.vq)
        z_p = lattice_decode(self.zq, se, self.z0)
        v_p = lattice_decode(self.vq, se, self.z0)
        dz, dv = self._pull(t_i, h_i, z_p, v_p,
                            _rwhere(live, lam_z,
                                    gmap(torch.zeros_like, lam_z)),
                            _rwhere(live, self.lam_v,
                                    gmap(torch.zeros_like, self.lam_v)))
        self.lam_z = _rwhere(live, dz, lam_z)
        self.lam_v = _rwhere(live, dv, self.lam_v)

    def close(self):
        """The initial-velocity closure: v0 = f(t0, z0) is part of the
        forward map, so λ_v flows into z0 and the args through f's
        pullback; the cotangent of ys[0] = z0 enters on the identity.
        Returns (dL/dz0, [dL/d leaf], None where a leaf takes none)."""
        with torch.enable_grad():
            z0 = gmap(lambda x: x.detach().requires_grad_(), self.z0)
            v0 = self._field0(z0)
            n_z = len(gleaves(z0))
            grads = torch.autograd.grad(gleaves(v0),
                                        gleaves(z0) + self.wrt_args,
                                        gleaves(self.lam_v),
                                        allow_unused=True)
        self._add_args(grads[n_z:])
        dz_v = ungroup([g if g is not None else torch.zeros_like(x)
                        for g, x in zip(grads[:n_z], gleaves(z0))])
        out = iter(self.gargs)
        return (gmap(lambda a, b, c: a + b + c, self.lam_z, dz_v,
                     gget(self.g_ys, 0)),
                [next(out) if d else None for d in self.diff])


def _rwhere(pred: torch.Tensor, a, b):
    """``torch.where`` with a (B,) predicate over batch-leading states."""
    return gmap(lambda x, y: torch.where(
        pred.reshape((-1,) + (1,) * (x.dim() - 1)), x, y), a, b)


def mali_backward_sweep(sw: MaliSweep):
    """The inverting reverse sweep from the terminal pair: (dL/dz0, [dL/d
    leaf]). No state buffer is read; each (z_i, v_i) is reconstructed by
    inverting the step after it. Batched, the sweep runs max_b n_b
    iterations (the backward's one host read)."""
    if sw.batched:
        n_max = sw.grid.n.max()
        n_steps = int(n_max)
        cost_hooks.loop_enter("mali-sweep-batched", dynamic=False)
        for j in range(n_steps):
            cost_hooks.trial(carry=(sw.lam_z, sw.lam_v))
            sw.step_batched(j)
    else:
        cost_hooks.loop_enter("mali-sweep", dynamic=False)
        for i in range(sw.grid.n - 1, -1, -1):
            cost_hooks.trial(carry=(sw.lam_z, sw.lam_v))
            sw.step(i)
    cost_hooks.loop_exit()
    return sw.close()


def _save_grid(ctx, grid: MaliGrid, z0) -> None:
    """The scalar grids, the terminal pair and z0 (each dtype group its
    own tensor) through ``save_for_backward``, where the saved-tensor hooks
    see them."""
    parts = [gleaves(z0)] + [gleaves(getattr(grid, k)) for k in _GRID]
    ctx.save_for_backward(*(x for p in parts for x in p))
    ctx.counts = [len(p) for p in parts]
    ctx.n = grid.n


def _saved_grid(ctx):
    saved, fields, j = ctx.saved_tensors, [], 0
    for count in ctx.counts:
        fields.append(ungroup(list(saved[j:j + count])))
        j += count
    return fields[0], MaliGrid(n=ctx.n, **dict(zip(_GRID, fields[1:])))


class _MaliSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, prob: _Problem, batched: bool, ts, *tensors):
        z0, arg_leaves = prob.split(tensors)
        engine = batched_mali_adaptive_solve if batched else \
            mali_adaptive_solve
        kw = {} if batched else {"group": prob.group}
        ys, grid, stats = engine(prob.f, z0, ts, prob.args(arg_leaves),
                                 prob.rtol, prob.atol, prob.cfg, h0=prob.h0,
                                 **kw)
        prob.stats = stats
        ctx.prob, ctx.batched, ctx.ts = prob, batched, ts
        _save_grid(ctx, grid, z0)
        ctx.status = stats.status
        ctx.arg_leaves = arg_leaves
        return ys

    @staticmethod
    def backward(ctx, *g_ys):
        # a frozen (NONFINITE_STATE) solve's, or row's, placeholder
        # outputs carry no gradient
        g_ys = gmap(lambda g: mask_failed_cotangents(
            g, ctx.status, batched=ctx.batched), ungroup(list(g_ys)))
        z0, grid = _saved_grid(ctx)
        prob = ctx.prob
        sw = MaliSweep(prob, grid, z0, ctx.ts, list(ctx.arg_leaves),
                       list(ctx.needs_input_grad[3 + prob.n_z:]), g_ys,
                       ctx.batched)
        dz0, dargs = mali_backward_sweep(sw)
        return (None, None, None, *gleaves(dz0), *dargs)


def _solve(f, z0, ts, args, rtol, atol, cfg, h0, use_pallas, batched,
           group=None):
    if cfg is None:
        cfg = ControllerConfig()
    flatten = maybe_flatten_batched if batched else maybe_flatten
    f, z0, unravel, use_pallas = flatten(f, z0, use_pallas)
    leaves, spec = pytree.tree_flatten(as_tuple(args))
    prob = _Problem(None, f, rtol, atol, cfg, h0, use_pallas, spec,
                    group=group)
    ys = _MaliSolve.apply(prob, batched, ts, *prob.inputs(z0, leaves))
    if unravel is not None:
        ys = unravel(ys)
    return ys, prob.stats


def odeint_mali(
    f: Callable,
    z0: Any,
    ts: torch.Tensor,
    args: Any = (),
    *,
    rtol: float = 1e-6,
    atol: float = 1e-6,
    cfg: Optional[ControllerConfig] = None,
    h0: Optional[torch.Tensor] = None,
    use_pallas: bool = False,
    group=None,
) -> Tuple[Any, SolveStats]:
    """Solve dz/dt = f(t, z, *args) with MALI gradients (no state buffer,
    the exact reverse reconstruction).

    Returns (ys, stats), ys stacked over ``ts`` (ys[0] = z0), differentiable
    with respect to ``z0`` (a tensor, or a pytree of floating tensors)
    and the floating tensors of ``args``; ``ts`` is a constant. The
    integrator is the second-order ALF pair stepper (``odeint``'s
    ``solver="alf"``). ``use_pallas`` ravels the state once per solve and
    runs the backward's half-drifts through kernel K1; the forward's
    lattice updates are integer tensor arithmetic either way. ``group``
    (a ``distributed.regions.SolveGroup``): ``z0`` is this rank's block of
    a split state, solved on the whole state's grid and lattice.
    """
    return _solve(f, z0, ts, args, rtol, atol, cfg, h0, use_pallas,
                  batched=False, group=group)


def odeint_mali_batched(
    f: Callable,
    z0: Any,
    ts: torch.Tensor,
    args: Any = (),
    *,
    rtol=1e-6,
    atol=1e-6,
    cfg: Optional[ControllerConfig] = None,
    h0: Optional[torch.Tensor] = None,
    use_pallas: bool = False,
) -> Tuple[Any, SolveStats]:
    """Per-sample batched MALI: ``odeint(..., batch_axis=0,
    grad_method="mali")``'s path.

    ``z0`` carries a leading batch dimension B and ``f`` is the
    per-sample field. Forward: ``batched_mali_adaptive_solve`` (per-row
    controllers, grids and lattices); backward: every row inverts its own
    accepted steps from its own terminal pair (K3 for the half-drifts
    under ``use_pallas``). Returns (ys (len(ts), B, ...), stats with (B,)
    fields); ``rtol``/``atol`` floats or (B,) tensors, ``h0`` a scalar or
    (B,).
    """
    return _solve(f, z0, ts, args, rtol, atol, cfg, h0, use_pallas,
                  batched=True)
