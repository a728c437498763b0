"""Adaptive Checkpoint Adjoint (ACA) — the paper's contribution, in torch.

Port of ``repro/core/odeint_aca.py::odeint_aca``, ``odeint_aca_batched``
and their backward sweeps.

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

Segmented (``checkpoint_segments=K``): the forward keeps K state
snapshots, the scalar grid still every step; the backward re-integrates
each segment from its snapshot with the saved stepsizes and the saved k0
carry (no search), into a ``seg_len``-slot replay buffer, then replays it
in reverse. State memory O(K + N_f / K) for about one more ψ per step;
the re-integrated states are the forward's bit for bit, so the gradients
are the full buffer's bit for bit. Batched, the replay windows are
end-aligned per row (row b replays step n_b - 1 - J at global iteration
J, as the full sweep does), each refilled from the nearest snapshot at or
before it (at most 2·seg_len ψ), so the rows pair and the args cotangent
adds up in the full sweep's order.

Natural grid (``interpolate_ts``): each replayed step also rebuilds its
interpolant, and the cotangents of the eval times it covered
(``[ev_lo, ev_hi)``) flow back through it.

Fixed grid (``odeint_aca_fixed``): the forward checkpoints every grid
state and the same backward sweep replays the grid — the naive fixed-grid
gradient, with {z_i} stored in place of every stage.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.kernels import cost_hooks

from .controller import ControllerConfig
from .groups import gget, gleaves, gmap, gset, gstack, gzeros, ungroup
from .integrate import (
    Checkpoints,
    SolveStats,
    adaptive_while_solve,
    as_tuple,
    batched_adaptive_while_solve,
    eval_theta,
    fixed_stats,
    fixed_status,
    make_fixed_grid,
    mask_failed_cotangents,
    resolve_segmentation,
)
from .stepper import (
    batched_field,
    interp_eval,
    interp_fit,
    maybe_flatten,
    maybe_flatten_batched,
    rk_step,
    rk_step_batched,
)
from .tableaus import Tableau


class _Problem:
    """What the autograd Function needs besides its tensor inputs."""

    def __init__(self, tab, f, rtol, atol, cfg, h0, use_pallas, args_spec,
                 steps_per_interval: Optional[int] = None,
                 checkpoint_segments=None, interpolate_ts: bool = False,
                 group=None):
        self.tab, self.f = tab, f
        # a SolveGroup where the state is this rank's block of a split one
        self.group = group
        self.rtol, self.atol, self.cfg, self.h0 = rtol, atol, cfg, h0
        self.use_pallas = use_pallas
        self.args_spec = args_spec
        # None: the adaptive engine; else the fixed grid's steps per
        # interval
        self.steps_per_interval = steps_per_interval
        self.n_seg, self.seg_len = (None, None) if cfg is None else \
            resolve_segmentation(checkpoint_segments, cfg.max_steps)
        self.interpolate_ts = interpolate_ts
        self.stats: Optional[SolveStats] = None
        # the state's tensors among the Function's inputs: 1, or its G
        # dtype groups
        self.n_z = 1

    def args(self, leaves) -> Tuple:
        return as_tuple(pytree.tree_unflatten(list(leaves), self.args_spec))

    def inputs(self, z0, arg_leaves) -> list:
        """The Function's tensor inputs after ``ts``: the state's tensors,
        then the args leaves (``n_z`` records how many are the state's)."""
        self.n_z = len(gleaves(z0))
        return gleaves(z0) + list(arg_leaves)

    def split(self, tensors):
        """(state, args leaves) of the Function's inputs after ``ts``."""
        return ungroup(list(tensors[:self.n_z])), tensors[self.n_z:]

    def engine_kw(self) -> dict:
        kw = dict(h0=self.h0, use_pallas=self.use_pallas,
                  checkpoint_segments=self.n_seg,
                  interpolate_ts=self.interpolate_ts)
        if self.group is not None:
            kw["group"] = self.group
        return kw


def _diff_args(prob: _Problem, arg_leaves: List, needs: List[bool]):
    """(args for the replay, the leaves that take a gradient, their mask):
    leaves of args that take a gradient become fresh autograd leaves."""
    diff = [bool(nd) and isinstance(a, torch.Tensor)
            and a.is_floating_point() for a, nd in zip(arg_leaves, needs)]
    leaves = [a.detach().requires_grad_() if d else a
              for a, d in zip(arg_leaves, diff)]
    wrt_args = [a for a, d in zip(leaves, diff) if d]
    return prob.args(leaves), wrt_args, diff


class _Sweep:
    """One reverse sweep's state and its replay of one accepted step, shared
    by the full and the segmented sweeps (solo or batched), which differ
    only in where each step's start state comes from."""

    def __init__(self, prob: _Problem, ckpts: Checkpoints, arg_leaves: List,
                 needs: List[bool], g_ys: torch.Tensor, ts: torch.Tensor,
                 batched: bool):
        self.prob, self.ckpts, self.g_ys, self.ts = prob, ckpts, g_ys, ts
        self.batched = batched
        self.args, self.wrt_args, self.diff = _diff_args(prob, arg_leaves,
                                                         needs)
        self.lam = gmap(torch.zeros_like, gget(g_ys, 0))
        self.gargs = [torch.zeros_like(a) for a in self.wrt_args]
        self.interp = ckpts.ev_lo is not None
        g0 = gleaves(g_ys)[0]
        self.karr = torch.arange(g0.shape[0], device=g0.device)

    def _local(self, t_i, h_i, z_i):
        """ψ(t_i, z_i, h_i) with the saved stepsize, k0 recomputed so its
        gradient flows; on the natural grid also the rebuilt interpolant
        at every eval time (its k0, k1 are the forward's carries bitwise,
        so it is the forward's interpolant)."""
        tab, f, up = self.prob.tab, self.prob.f, self.prob.use_pallas
        step = rk_step_batched if self.batched else rk_step
        res = step(tab, f, t_i, z_i, h_i, self.args, use_pallas=up,
                   dense=self.interp)
        if not self.interp:
            return res.z_next, None
        if tab.fsal:
            k1 = res.k_last
        elif self.batched:
            k1 = batched_field(f, self.args)(t_i + h_i, res.z_next)
        else:
            k1 = f(t_i + h_i, res.z_next, *self.args)
        coeffs = interp_fit(z_i, res.z_next, res.k_first, k1, h_i,
                            res.z_mid)
        return res.z_next, interp_eval(coeffs,
                                       eval_theta(self.ts, t_i, h_i))

    def replay(self, i, z_i, live=None) -> None:
        """Back-propagate λ through accepted step ``i`` (an int, or (B,)
        row indices with the ``live`` mask when batched) started at
        ``z_i``, first injecting the cotangent of an output that landed on
        its endpoint: λ(t_{i+1}) += ∂J/∂y_k."""
        ck, g_ys = self.ckpts, self.g_ys
        if self.batched:
            rows = torch.arange(i.shape[0], device=i.device)
            t_i = ck.t[rows, i]
            h_i = torch.where(live, ck.h[rows, i], torch.zeros_like(t_i))
            oi = torch.where(live, ck.out_idx[rows, i],
                             torch.full_like(ck.out_idx[rows, i], -1))
            g_k = gget(g_ys, (oi.clamp(min=0).long(), rows))
            lam = gmap(lambda la, gk: torch.where((oi >= 0).reshape(
                (-1,) + (1,) * (la.dim() - 1)), la + gk, la), self.lam, g_k)
        else:
            t_i, h_i, oi = ck.t[i], ck.h[i], ck.out_idx[i]
            g_k = gmap(lambda g: g.index_select(
                0, oi.clamp(min=0).reshape(1).long())[0], g_ys)
            lam = gmap(lambda la, gk: torch.where(oi >= 0, la + gk, la),
                       self.lam, g_k)
        with torch.enable_grad():
            z_i = gmap(lambda x: x.detach().requires_grad_(), z_i)
            z_next, y_all = self._local(t_i, h_i, z_i)
            outs, cots = gleaves(z_next), gleaves(lam)
            if y_all is not None:
                # the interpolated outputs' cotangents, masked to the eval
                # times this interval covered
                if self.batched:
                    m = (live[None, :]
                         & (self.karr[:, None] >= ck.ev_lo[rows, i][None, :])
                         & (self.karr[:, None] < ck.ev_hi[rows, i][None, :]))
                else:
                    m = (self.karr >= ck.ev_lo[i]) & (self.karr < ck.ev_hi[i])
                for y, g in zip(gleaves(y_all), gleaves(g_ys)):
                    mg = m.reshape(tuple(m.shape)
                                   + (1,) * (g.dim() - m.dim()))
                    outs.append(y)
                    cots.append(torch.where(mg, g, torch.zeros_like(g)))
            n_z = len(gleaves(z_i))
            grads = torch.autograd.grad(outs, gleaves(z_i) + self.wrt_args,
                                        cots, allow_unused=True)
        self.lam = ungroup([g if g is not None else torch.zeros_like(la)
                            for g, la in zip(grads[:n_z], gleaves(lam))])
        self.gargs = [ga if d is None else ga + d
                      for ga, d in zip(self.gargs, grads[n_z:])]

    def result(self):
        """(dL/dz0, [dL/d leaf], None where a leaf takes no gradient): the
        cotangent of ys[0] = z0 enters on the identity path."""
        out = iter(self.gargs)
        return (gmap(lambda la, g: la + g, self.lam, gget(self.g_ys, 0)),
                [next(out) if d else None for d in self.diff])


def _aca_backward_sweep(sw: _Sweep):
    """Reverse sweep over the full checkpoint buffer: every accepted step
    replayed from its stored start state."""
    cost_hooks.loop_enter("aca-sweep", dynamic=False)
    for i in range(sw.ckpts.n - 1, -1, -1):
        cost_hooks.trial(carry=(sw.lam,))
        sw.replay(i, gget(sw.ckpts.z, i))
    cost_hooks.loop_exit()
    return sw.result()


@torch.no_grad()
def _reintegrate(prob: _Problem, args: Tuple, ckpts: Checkpoints, z, k0,
                 i, h_i, batched: bool):
    """One saved-stepsize ψ of the segment re-integration and the next k0
    carry, chained as the forward chained it: (z_next, k0_next)."""
    tab, f = prob.tab, prob.f
    if batched:
        rows = torch.arange(i.shape[0], device=i.device)
        t_i = ckpts.t[rows, i]
        res = rk_step_batched(tab, f, t_i, z, h_i, args, k0=k0,
                              use_pallas=prob.use_pallas)
        k0n = res.k_last if tab.fsal else \
            batched_field(f, args)(t_i + h_i, res.z_next)
    else:
        t_i = ckpts.t[i]
        res = rk_step(tab, f, t_i, z, h_i, args, k0=k0,
                      use_pallas=prob.use_pallas)
        k0n = res.k_last if tab.fsal else f(t_i + h_i, res.z_next, *args)
    return res.z_next, k0n


def _aca_backward_sweep_segmented(sw: _Sweep):
    """Segmented reverse sweep (``checkpoint_segments=K``): segments last to
    first, each re-integrated from its snapshot into the ``seg_len``-slot
    replay buffer with the saved stepsizes and the re-chained k0 carry
    (the states the forward took, bitwise), then replayed in reverse as
    ``_aca_backward_sweep`` does. The step whose end no replay needs is
    not re-taken."""
    ck, seg_len = sw.ckpts, sw.prob.seg_len
    n = ck.n
    zbuf = gmap(lambda x: torch.empty((seg_len,) + tuple(x.shape[1:]),
                                      dtype=x.dtype, device=x.device), ck.z)
    cost_hooks.loop_enter("aca-segments", dynamic=False)
    for s in range(-(-n // seg_len) - 1, -1, -1):
        cost_hooks.trial(carry=(sw.lam,))
        i0, i1 = s * seg_len, min(s * seg_len + seg_len, n)
        z, k0 = gget(ck.z, s), gget(ck.k0, s)
        gset(zbuf, 0, z)
        for i in range(i0, i1 - 1):
            z, k0 = _reintegrate(sw.prob, sw.args, ck, z, k0, i, ck.h[i],
                                 batched=False)
            gset(zbuf, i + 1 - i0, z)
        for i in range(i1 - 1, i0 - 1, -1):
            sw.replay(i, gget(zbuf, i - i0))
    cost_hooks.loop_exit()
    return sw.result()


def _save_checkpoints(ctx, ckpts: Checkpoints) -> None:
    """Keep the trajectory checkpoint for the backward through
    ``save_for_backward``, where autograd's saved-tensor hooks see it: the
    scalar grids, the state buffer or snapshots (each dtype group its own
    tensor), the snapshots' k0 and the natural grid's eval ranges."""
    names = [k for k in ("t", "h", "z", "out_idx", "k0", "ev_lo", "ev_hi")
             if getattr(ckpts, k) is not None]
    parts = [gleaves(getattr(ckpts, k)) for k in names]
    ctx.save_for_backward(*(x for p in parts for x in p))
    ctx.ckpt_names = [(k, len(p)) for k, p in zip(names, parts)]
    ctx.n = ckpts.n


def _saved_checkpoints(ctx) -> Checkpoints:
    saved, fields, j = ctx.saved_tensors, {}, 0
    for k, count in ctx.ckpt_names:
        fields[k] = ungroup(list(saved[j:j + count]))
        j += count
    return Checkpoints(n=ctx.n, **fields)


class _AcaSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, prob: _Problem, ts, *tensors):
        z0, arg_leaves = prob.split(tensors)
        args = prob.args(arg_leaves)
        if prob.steps_per_interval is None:
            ys, ckpts, stats = adaptive_while_solve(
                prob.tab, prob.f, z0, ts, args, prob.rtol, prob.atol,
                prob.cfg, **prob.engine_kw())
        else:
            ys, ckpts, stats = _fixed_checkpoint_solve(
                prob.tab, prob.f, z0, ts, args, prob.steps_per_interval,
                prob.use_pallas)
        prob.stats = stats
        ctx.prob, ctx.ts = prob, ts
        _save_checkpoints(ctx, ckpts)
        ctx.status = stats.status
        ctx.arg_leaves = arg_leaves
        return ys

    @staticmethod
    def backward(ctx, *g_ys):
        prob = ctx.prob
        # a frozen (NONFINITE_STATE) solve's placeholder outputs carry no
        # gradient: zero the cotangents before the replay sweep
        g_ys = gmap(lambda g: mask_failed_cotangents(g, ctx.status),
                    ungroup(list(g_ys)))
        sw = _Sweep(prob, _saved_checkpoints(ctx), list(ctx.arg_leaves),
                    list(ctx.needs_input_grad[2 + prob.n_z:]), g_ys, ctx.ts,
                    batched=False)
        sweep = _aca_backward_sweep if prob.n_seg is None else \
            _aca_backward_sweep_segmented
        dz0, dargs = sweep(sw)
        return (None, None, *gleaves(dz0), *dargs)


def _aca_backward_sweep_batched(sw: _Sweep):
    """Per-row reverse sweep: each batch row replays its own grid.

    ``ckpts`` rows are per row (t/h/out_idx (B, S), z (B, S, ...), n
    (B,)); ``g_ys`` is (n_eval, B, ...). The sweep runs max(n) iterations;
    at iteration j row b replays its slot n_b - 1 - j, and once j >= n_b it
    replays slot 0 with h = 0, the identity in z with a zero cotangent for
    args, so its λ is untouched. The args cotangent is summed over the
    rows, since args are shared.
    """
    n = sw.ckpts.n
    rows = torch.arange(n.shape[0], device=n.device)
    n_max = n.max()
    # the backward's one host read: the replay length max_b n_b
    n_steps = int(n_max)
    cost_hooks.loop_enter("aca-sweep-batched", dynamic=False)
    for j in range(n_steps):
        cost_hooks.trial(carry=(sw.lam,))
        i = n - 1 - j                        # (B,), negative when done
        i_c = i.clamp(min=0).long()
        sw.replay(i_c, gget(sw.ckpts.z, (rows, i_c)), live=i >= 0)
    cost_hooks.loop_exit()
    return sw.result()


def _aca_backward_sweep_segmented_batched(sw: _Sweep):
    """Batched segmented reverse sweep (``checkpoint_segments`` with
    ``batch_axis``).

    Rows record different step counts n_b, so their segments do not
    align. The replay windows are end-aligned per row: at global iteration
    J = j·seg_len + r row b replays its step n_b − 1 − J, the pairing (and
    so the order in which the args cotangent adds up over the rows) of
    ``_aca_backward_sweep_batched``. Every seg_len iterations each row
    refills its slots of the replay buffer by re-integrating from the
    nearest snapshot at or before its window (at most 2·seg_len ψ, since a
    window can straddle a snapshot stride), rows outside theirs frozen
    with h = 0. The windows are planned on the host from one read of n.
    """
    ck, prob = sw.ckpts, sw.prob
    seg_len, n_snap = prob.seg_len, gleaves(ck.z)[0].shape[1]
    n_host = ck.n.tolist()               # the backward's one host read
    B = len(n_host)
    dev = ck.n.device
    rows = torch.arange(B, device=dev)
    n_max = max(n_host)
    zbuf = gzeros((B, seg_len), ck.z, keep=2)
    cost_hooks.loop_enter("aca-segments-batched", dynamic=False)
    for j in range(-(-n_max // seg_len)):
        cost_hooks.trial(carry=(sw.lam,))
        g_hi = [nb - j * seg_len for nb in n_host]      # window end (excl.)
        g_lo = [max(g - seg_len, 0) for g in g_hi]      # window start
        snap = [min(lo // seg_len, n_snap - 1) for lo in g_lo]
        a0 = [s * seg_len for s in snap]                # snapshot's step
        # the refill: each row steps from its snapshot to its window's
        # last start state
        span = max(g - a for g, a in zip(g_hi, a0) if g > 0)
        g_hi_t, g_lo_t, a0_t = (torch.tensor(v, device=dev)
                                for v in (g_hi, g_lo, a0))
        snap_t = torch.tensor(snap, device=dev)
        z, k0 = gget(ck.z, (rows, snap_t)), gget(ck.k0, (rows, snap_t))
        for q in range(span):
            i = a0_t + q
            in_win = (i >= g_lo_t) & (i < g_hi_t)
            slot = (i - g_lo_t).clamp(0, seg_len - 1)
            gset(zbuf, (rows, slot), gmap(lambda x, b: torch.where(
                in_win.reshape((-1,) + (1,) * (x.dim() - 1)), x, b), z,
                gget(zbuf, (rows, slot))))
            if q + 1 < span:
                # rows whose next start state is past their window step
                # with h = 0, the identity
                i_c = i.clamp(max=ck.t.shape[1] - 1)
                h_i = torch.where(i + 1 < g_hi_t, ck.h[rows, i_c],
                                  torch.zeros_like(ck.h[rows, i_c]))
                z, k0 = _reintegrate(prob, sw.args, ck, z, k0, i_c, h_i,
                                     batched=True)
        for r in range(seg_len):
            jj = j * seg_len + r
            if jj >= n_max:
                break
            i = ck.n - 1 - jj                        # (B,), < 0 when done
            i_c = i.clamp(min=0).long()
            slot = (i - g_lo_t).clamp(0, seg_len - 1)
            sw.replay(i_c, gget(zbuf, (rows, slot)), live=i >= 0)
    cost_hooks.loop_exit()
    return sw.result()


class _AcaSolveBatched(torch.autograd.Function):
    @staticmethod
    def forward(ctx, prob: _Problem, ts, *tensors):
        z0, arg_leaves = prob.split(tensors)
        args = prob.args(arg_leaves)
        ys, ckpts, stats = batched_adaptive_while_solve(
            prob.tab, prob.f, z0, ts, args, prob.rtol, prob.atol, prob.cfg,
            **prob.engine_kw())
        prob.stats = stats
        ctx.prob, ctx.ts = prob, ts
        _save_checkpoints(ctx, ckpts)
        ctx.status = stats.status
        ctx.arg_leaves = arg_leaves
        return ys

    @staticmethod
    def backward(ctx, *g_ys):
        prob = ctx.prob
        # failed rows: their frozen placeholder outputs carry no gradient,
        # into neither their own dz0 nor the shared args
        g_ys = gmap(lambda g: mask_failed_cotangents(g, ctx.status,
                                                     batched=True),
                    ungroup(list(g_ys)))
        sw = _Sweep(prob, _saved_checkpoints(ctx), list(ctx.arg_leaves),
                    list(ctx.needs_input_grad[2 + prob.n_z:]), g_ys, ctx.ts,
                    batched=True)
        sweep = _aca_backward_sweep_batched if prob.n_seg is None else \
            _aca_backward_sweep_segmented_batched
        dz0, dargs = sweep(sw)
        return (None, None, *gleaves(dz0), *dargs)


@torch.no_grad()
def _fixed_checkpoint_solve(tab: Tableau, f: Callable, z0,
                            ts: torch.Tensor, args: Tuple,
                            steps_per_interval: int, use_pallas: bool):
    """The fixed grid without autograd, every grid step's start state
    checkpointed: (ys, checkpoints, stats)."""
    t_grid, h_grid = make_fixed_grid(ts, steps_per_interval)
    n_steps = t_grid.shape[0]
    ckpt_z = gmap(lambda x: torch.empty((n_steps,) + tuple(x.shape),
                                        dtype=x.dtype, device=x.device), z0)
    ys = [z0]
    z = z0
    cost_hooks.loop_enter("fixed-grid", dynamic=False)
    for j in range(n_steps):
        cost_hooks.trial(carry=(z,))
        gset(ckpt_z, j, z)
        z = rk_step(tab, f, t_grid[j], z, h_grid[j], args,
                    use_pallas=use_pallas).z_next
        if (j + 1) % steps_per_interval == 0:
            ys.append(z)
    cost_hooks.loop_exit()
    ys = gstack(ys)
    # step j's endpoint lands on ts[(j + 1) / steps] at an interval's end
    j1 = torch.arange(1, n_steps + 1, device=ts.device)
    out_idx = torch.where(j1 % steps_per_interval == 0,
                          j1 // steps_per_interval, -1).to(torch.int32)
    ckpts = Checkpoints(t=t_grid, h=h_grid, z=ckpt_z, out_idx=out_idx,
                        n=n_steps)
    return ys, ckpts, fixed_stats(tab, n_steps, fixed_status(ys))


def odeint_aca_batched(
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
    checkpoint_segments=None,
    interpolate_ts: bool = False,
) -> Tuple[torch.Tensor, SolveStats]:
    """Per-sample batched ACA: ``odeint(..., batch_axis=0)``'s path.

    ``z0`` carries a leading batch dimension B and ``f`` is the
    per-sample field. Forward: ``batched_adaptive_while_solve``, every
    row on its own grid. Backward: each row's grid replayed in reverse
    (``_aca_backward_sweep_batched``), so every row's gradient is that of
    its own numerical solution. Returns (ys (len(ts), B, ...), stats with
    (B,) fields). ``rtol``/``atol`` are floats or (B,) tensors (per-row
    tolerances; no gradient); ``h0`` a scalar or (B,).
    ``checkpoint_segments`` (int, ``"auto"`` or None) bounds each row's
    state buffer to K snapshots plus the replay buffer, with the full
    buffer's gradients bit for bit; ``interpolate_ts`` as in
    ``odeint_aca``, every row on its own natural grid.
    """
    if cfg is None:
        cfg = ControllerConfig()
    if not solver.adaptive:
        raise ValueError(
            "odeint_aca_batched requires an embedded adaptive tableau; "
            "fixed grids batch losslessly through odeint_aca_fixed")
    f, z0, unravel, use_pallas = maybe_flatten_batched(f, z0, use_pallas)
    leaves, spec = pytree.tree_flatten(as_tuple(args))
    prob = _Problem(solver, f, rtol, atol, cfg, h0, use_pallas, spec,
                    checkpoint_segments=checkpoint_segments,
                    interpolate_ts=interpolate_ts)
    ys = _AcaSolveBatched.apply(prob, ts, *prob.inputs(z0, leaves))
    if unravel is not None:
        ys = unravel(ys)
    return ys, prob.stats


def odeint_aca(
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
    checkpoint_segments=None,
    interpolate_ts: bool = False,
    group=None,
) -> Tuple[torch.Tensor, SolveStats]:
    """Solve dz/dt = f(t, z, *args) with ACA gradients.

    Returns (ys, stats) with ys stacked over ``ts`` (ys[0] = z0).
    Differentiable with respect to ``z0`` (a tensor, or a pytree of
    floating tensors) and every floating tensor in ``args``
    (a tensor, or a tuple/list/dict nesting of tensors); ``ts`` is a
    constant, as in the paper. ``use_pallas`` flattens the state once per
    solve and runs the trial loop and the backward replay on the fused
    kernel path; the flatten and unflatten sit outside the autograd
    Function, so cotangents pass through them as reshapes.

    ``checkpoint_segments`` (int K, ``"auto"`` or None) keeps K state
    snapshots in place of every accepted state; the backward re-integrates
    each segment with the saved stepsizes before replaying it, so the
    gradients are the full buffer's bit for bit at about one more ψ per
    step. ``interpolate_ts`` advances on the controller's natural grid and
    reads interior eval times off each accepted step's interpolant; the
    backward replays each interval and its interpolant, so the gradient is
    still that of the computed (interpolated) solution. ``ys[0]`` and
    ``ys[-1]`` stay exact solver states. ``group`` (a
    ``distributed.regions.SolveGroup``): ``z0`` is this rank's block of a
    split state, solved on the whole state's grid.
    """
    if cfg is None:
        cfg = ControllerConfig()
    if not solver.adaptive:
        raise ValueError(
            "odeint_aca requires an embedded adaptive tableau; fixed grids "
            "take odeint_aca_fixed")
    f, z0, unravel, use_pallas = maybe_flatten(f, z0, use_pallas)
    leaves, spec = pytree.tree_flatten(as_tuple(args))
    prob = _Problem(solver, f, rtol, atol, cfg, h0, use_pallas, spec,
                    checkpoint_segments=checkpoint_segments,
                    interpolate_ts=interpolate_ts, group=group)
    ys = _AcaSolve.apply(prob, ts, *prob.inputs(z0, leaves))
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
    ys = _AcaSolve.apply(prob, ts, *prob.inputs(z0, leaves))
    if unravel is not None:
        ys = unravel(ys)
    return ys, prob.stats
