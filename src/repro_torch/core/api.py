"""The ``odeint`` front door of the port: ACA, adjoint and naive
gradients, adaptive and fixed grids, solo or batched.

Port of ``repro/core/api.py::odeint`` / ``odeint_final``::

    ys, stats = odeint(f, z0, ts, args, solver="dopri5", grad_method="aca",
                       rtol=1e-6, atol=1e-6, max_steps=256, max_trials=12,
                       steps_per_interval=8, trial_budget=None,
                       use_pallas=False, checkpoint_segments=None,
                       interpolate_ts=False, h0=None, on_failure="status")

``f(t, z, *args) -> dz/dt``; ``z0`` one floating tensor or a pytree
(dict, tuple, list, NamedTuple) of tensors of one floating dtype, raveled
once per solve; ``ts`` strictly monotone — ascending, or descending for a
reverse-time solve (solved as the time-negated ascending problem);
``ys[k] = z(ts[k])`` with ``ys[0] = z0`` (``ys`` has z0's structure, each
leaf stacked over ``ts``). The solve runs on ``z0``'s device; ``ts`` moves
there. Gradients flow to ``z0`` and to the floating tensors of ``args``.

``grad_method`` picks how: ``"aca"`` (the paper's checkpoint replay),
``"adjoint"`` (Chen et al.'s reverse solve of the augmented system, O(N_f)
memory) or ``"naive"`` (autograd through the whole solver, the stepsize
search included; ``trial_budget`` bounds its trials). A fixed-step
``solver`` (``"euler"``, ``"midpoint"``, ``"rk2"``, ``"rk4"``) integrates
``steps_per_interval`` uniform steps between eval times, with any of the
three methods.

``batch_axis=a`` solves every slice of ``z0`` along axis ``a`` as its own
problem (``f`` is the per-sample field), each on its own adaptive grid;
``ys[k]`` keeps the batch at axis ``a`` and ``stats`` fields are (B,).
There ``rtol``/``atol`` may be (B,) arrays, one tolerance per row,
``h0`` a (B,) array, and ``ts`` a (B, T) array, one row of eval times per
sample (every row strictly monotone in one direction; ``ys[k]`` then
holds row b's state at ``ts[b, k]``)::

    ys, stats = odeint(f, z0, ts, args, batch_axis=0,
                       rtol=torch.tensor([1e-3, 1e-5]), atol=1e-6)

Fixed grids are shared by every row: the batch runs as one system with
the field vmapped over it.

``checkpoint_segments=K`` (or ``"auto"``: ceil(sqrt(max_steps))) keeps
K state snapshots in place of ACA's full trajectory buffer, with the same
gradients bit for bit; ``interpolate_ts=True`` advances on the
controller's natural grid and reads interior eval times off each step's
interpolant (aca, adjoint, naive; solo or a 1-D ``ts`` under
``batch_axis``). ``odeint_dense`` solves once and returns a
``DenseSolution`` to read at any time. Options of later slices keep the
reference's signature and raise a ``ValueError`` naming the slice
(ROADMAP queue 1) that brings them.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch.func import vmap
from torch.utils import _pytree as pytree

from .controller import ControllerConfig
from .integrate import SolveStats, adaptive_while_solve, as_tuple
from .odeint_aca import odeint_aca, odeint_aca_batched, odeint_aca_fixed
from .odeint_adjoint import (
    odeint_adjoint,
    odeint_adjoint_batched,
    odeint_adjoint_fixed,
)
from .odeint_naive import (
    odeint_naive,
    odeint_naive_batched,
    odeint_naive_fixed,
)
from .stepper import (
    InterpCoeffs,
    interp_eval_aligned,
    maybe_flatten,
    state_leaves,
)
from .tableaus import Tableau, get_tableau

GRAD_METHODS = ("aca", "adjoint", "naive")

ON_FAILURE_POLICIES = ("status",)

_ADAPTIVE = {"aca": odeint_aca, "adjoint": odeint_adjoint,
             "naive": odeint_naive}
_BATCHED = {"aca": odeint_aca_batched, "adjoint": odeint_adjoint_batched,
            "naive": odeint_naive_batched}
_FIXED = {"aca": odeint_aca_fixed, "adjoint": odeint_adjoint_fixed,
          "naive": odeint_naive_fixed}


def _later(what: str, slice_: str) -> ValueError:
    return ValueError(
        f"{what} is not ported yet: it comes with {slice_} (ROADMAP queue 1)")


def _ts_direction(ts: torch.Tensor) -> int:
    """+1 for strictly ascending ``ts``, -1 for strictly descending;
    ValueError for anything else (repeated times included). Every row of
    a (B, T) ``ts`` must run in the same direction."""
    d = ts[..., 1:] - ts[..., :-1]
    if bool((d > 0).all()):
        return 1
    if bool((d < 0).all()):
        return -1
    raise ValueError(
        "ts must be strictly monotone: ascending (forward solve) or "
        "descending (reverse-time solve); got neither — sort your eval "
        "times (and deduplicate repeats) before calling odeint"
        + ("; per-row ts must all run in one direction"
           if ts.dim() == 2 else ""))


def _negate_time(f: Callable) -> Callable:
    """dz/ds = -f(-s, z) over ascending s = -t is the reverse-time solve
    over descending t."""
    def f_neg(s, z, *a):
        return pytree.tree_map(torch.neg, f(-s, z, *a))

    return f_neg


def odeint(
    f: Callable,
    z0: Any,
    ts,
    args: Any = (),
    *,
    solver: Optional[Union[str, Tableau]] = None,
    grad_method: str = "aca",
    rtol: float = 1e-6,
    atol: float = 1e-6,
    max_steps: int = 256,
    max_trials: int = 12,
    steps_per_interval: int = 8,
    trial_budget: Optional[int] = None,
    use_pallas: bool = False,
    batch_axis: Optional[int] = None,
    checkpoint_segments: Optional[Union[int, str]] = None,
    interpolate_ts: bool = False,
    h0: Optional[Any] = None,
    on_failure: str = "status",
    mesh: Optional[Any] = None,
    shard_rules: Optional[Any] = None,
) -> Tuple[Any, SolveStats]:
    """Solve dz/dt = f(t, z, *args) through ``ts``; see the module
    docstring.

    ``max_steps`` caps the accepted steps (the checkpoint capacity;
    ``stats.overflow`` is set when the solve runs out before the last
    eval time) and ``max_trials`` the stepsize search per step; the naive
    method's trials are bounded by ``trial_budget`` (default ``max_steps
    * max_trials``). ``steps_per_interval`` sets a fixed-step solver's
    grid. ``use_pallas=True`` flattens the state once per solve and runs
    every stage sum and error norm through kernels K1 and K2, or K3 and
    K4/K5 under ``batch_axis`` (their plain versions for a CPU state).
    ``h0`` overrides the initial-stepsize heuristic of an adaptive
    solver. ``stats.status`` carries a ``SolveStatus`` code
    (``on_failure="status"``). ``checkpoint_segments`` (ACA with an
    adaptive solver) and ``interpolate_ts`` (adaptive solvers) as in the
    module docstring.
    """
    if grad_method == "mali":
        raise _later("grad_method='mali'", "slice F")
    if grad_method not in GRAD_METHODS:
        raise ValueError(f"grad_method must be one of {GRAD_METHODS}")
    if on_failure != "status":
        raise _later(f"on_failure={on_failure!r}", "slice E")
    if solver is None:
        solver = "dopri5"
    if isinstance(solver, str) and solver.lower().replace("-", "_") == "alf":
        raise _later("solver='alf' (the reversible pair integrator)",
                     "slice F")
    tab = get_tableau(solver) if isinstance(solver, str) else solver
    leaves, _ = state_leaves(z0)
    device = leaves[0].device
    if checkpoint_segments is not None and (
            grad_method != "aca" or not tab.adaptive):
        raise ValueError(
            "checkpoint_segments requires grad_method='aca' with an "
            f"adaptive solver (got {grad_method!r} / {tab.name!r}): only "
            "the ACA trajectory checkpoint stores per-step states to "
            "segment")
    if interpolate_ts and not tab.adaptive:
        raise ValueError(
            "interpolate_ts requires an adaptive solver (got "
            f"{tab.name!r}): fixed grids land on every eval time by "
            "construction, there is no stepsize search to relieve")
    if h0 is not None and not tab.adaptive:
        raise ValueError(
            f"h0 overrides the adaptive initial-stepsize heuristic; "
            f"fixed-grid solver {tab.name!r} has no stepsize controller "
            "— use steps_per_interval to refine its grid instead")
    rtol, atol = _tolerances(rtol, atol, batch_axis, mesh, tab, device)
    if mesh is not None or shard_rules is not None:
        raise _later("mesh / shard_rules (sharded solving)", "slice I")

    ts = torch.as_tensor(ts, device=device)
    if not ts.is_floating_point():
        ts = ts.to(torch.float32)
    if ts.dim() == 2 and batch_axis is None:
        raise ValueError(
            "ts of shape (B, T) gives every batch row its own eval times "
            "and requires batch_axis; pass batch_axis=a, or a 1D ts for a "
            "single-sample solve")
    if ts.dim() not in (1, 2) or ts.shape[-1] < 2:
        raise ValueError("ts must be a 1D array of at least 2 times (or, "
                         "under batch_axis, (B, T) per-row times)")
    if ts.dim() == 2 and interpolate_ts:
        raise ValueError(
            "interpolate_ts with per-row (B, T) ts is not ported (ROADMAP "
            "queue 1, 'per-row ts with interpolate_ts'): pass the union of "
            "the rows' times as one 1-D ts (data.merged_time_grid) and "
            "gather each row's outputs, as the reference's route does")
    if _ts_direction(ts) < 0:
        # reverse time: solve the time-negated problem over ascending -ts
        f, ts = _negate_time(f), -ts

    cfg = ControllerConfig(max_steps=max_steps, max_trials=max_trials)
    if h0 is not None:
        h0 = torch.as_tensor(h0, dtype=ts.dtype, device=device)
    if batch_axis is not None:
        return _odeint_batched(f, z0, ts, args, tab=tab,
                               grad_method=grad_method,
                               batch_axis=batch_axis, rtol=rtol, atol=atol,
                               cfg=cfg, steps_per_interval=steps_per_interval,
                               trial_budget=trial_budget, h0=h0,
                               use_pallas=use_pallas,
                               checkpoint_segments=checkpoint_segments,
                               interpolate_ts=interpolate_ts)
    if not tab.adaptive:
        return _FIXED[grad_method](f, z0, ts, args, solver=tab,
                                   steps_per_interval=steps_per_interval,
                                   use_pallas=use_pallas)
    return _ADAPTIVE[grad_method](
        f, z0, ts, args, solver=tab, rtol=rtol, atol=atol, cfg=cfg, h0=h0,
        use_pallas=use_pallas, interpolate_ts=interpolate_ts,
        **_method_kw(grad_method, trial_budget, checkpoint_segments))


def _method_kw(grad_method: str, trial_budget: Optional[int],
               checkpoint_segments) -> dict:
    """The keywords one gradient method takes beyond the common ones."""
    if grad_method == "naive":
        return dict(trial_budget=trial_budget)
    if grad_method == "aca":
        return dict(checkpoint_segments=checkpoint_segments)
    return {}


def _tolerances(rtol, atol, batch_axis, mesh, tab: Tableau, device):
    """Floats, or (under ``batch_axis``) rank-1 f32 tensors on ``device``
    when either tolerance is an array: one tolerance per batch row. Raises
    the reference's named errors for array tolerances elsewhere."""
    if _rank(rtol) == 0 and _rank(atol) == 0:
        return float(rtol), float(atol)
    if batch_axis is None:
        raise ValueError(
            "array rtol/atol are *per-element* tolerances and require "
            "batch_axis: each entry pairs with one batch row's stepsize "
            "controller — pass batch_axis=a, or a scalar tolerance for a "
            "single-sample solve")
    if mesh is not None:
        raise ValueError(
            "per-element rtol/atol do not compose with mesh: the (B,) "
            "tolerance rows would have to be sharded with the batch; drop "
            "mesh or use a scalar tolerance")
    if not tab.adaptive:
        raise ValueError(
            f"per-element rtol/atol require an adaptive solver (got "
            f"{tab.name!r}): fixed grids have no error control to point a "
            "tolerance at — use steps_per_interval instead")
    rtol, atol = (torch.as_tensor(x, dtype=torch.float32, device=device)
                  for x in (rtol, atol))
    if rtol.dim() > 1 or atol.dim() > 1:
        raise ValueError(
            "per-element rtol/atol must be rank-1 (one tolerance per batch "
            f"row); got shapes {tuple(rtol.shape)} / {tuple(atol.shape)}")
    return rtol, atol


def _rank(x) -> int:
    return x.dim() if isinstance(x, torch.Tensor) else np.ndim(x)


def _odeint_batched(f: Callable, z0: Any, ts: torch.Tensor, args: Any, *,
                    tab: Tableau, grad_method: str, batch_axis: int, rtol,
                    atol, cfg: ControllerConfig, steps_per_interval: int,
                    trial_budget: Optional[int], h0: Optional[torch.Tensor],
                    use_pallas: bool, checkpoint_segments=None,
                    interpolate_ts: bool = False) -> Tuple[Any, SolveStats]:
    """``odeint(..., batch_axis=a)``: moves the batch to axis 0 of every
    state leaf, routes adaptive tableaus to the per-sample batched solvers
    and fixed grids to the shared grid with the field vmapped over the
    batch, and moves the batch back in ``ys``, where it sits one axis
    deeper under the time axis."""
    leaves, _ = state_leaves(z0)
    for leaf in leaves:
        if leaf.dim() == 0:
            raise ValueError(
                f"batch_axis={batch_axis} requires every state leaf to "
                "carry a batch dimension, but a leaf is rank-0 (a scalar "
                "has no axis to batch over)")
    axes = pytree.tree_map(lambda x: batch_axis % x.dim(), z0)
    sizes = {x.shape[a] for x, a in zip(leaves, pytree.tree_leaves(axes))}
    if len(sizes) != 1:
        raise ValueError(
            f"all state leaves must share one batch size at axis "
            f"{batch_axis}; got {sorted(sizes)}")
    B = sizes.pop()
    if ts.dim() == 2:
        if ts.shape[0] != B:
            raise ValueError(
                f"per-row ts must carry one row of eval times per batch "
                f"row (B={B}); got shape {tuple(ts.shape)}")
        if not tab.adaptive:
            raise ValueError(
                f"per-row ts require an adaptive solver (got {tab.name!r}): "
                "a fixed grid is shared by every row")
    for name, tol in (("rtol", rtol), ("atol", atol)):
        if isinstance(tol, torch.Tensor) and tol.dim() == 1 \
                and tol.shape[0] not in (1, B):
            raise ValueError(
                f"per-element {name} must carry one entry per batch row "
                f"(B={B}) or a single broadcastable entry; got shape "
                f"{tuple(tol.shape)}")
    if h0 is not None and h0.dim() > 0 and tuple(h0.shape) not in ((1,),
                                                                   (B,)):
        raise ValueError(
            f"a per-row h0 must have shape ({B},); got {tuple(h0.shape)}")
    z0 = pytree.tree_map(lambda x, a: x.movedim(a, 0), z0, axes)
    if tab.adaptive:
        ys, stats = _BATCHED[grad_method](
            f, z0, ts, args, solver=tab, rtol=rtol, atol=atol, cfg=cfg,
            h0=h0, use_pallas=use_pallas, interpolate_ts=interpolate_ts,
            **_method_kw(grad_method, trial_budget, checkpoint_segments))
    else:
        # a fixed grid is the same for every row: lockstep is the
        # per-sample grid, so the batch runs as one system
        def fb(t, z, *a):
            return vmap(lambda zi: f(t, zi, *a))(z)

        ys, stats = _FIXED[grad_method](
            fb, z0, ts, args, solver=tab,
            steps_per_interval=steps_per_interval, use_pallas=use_pallas)
        stats = SolveStats(*(s.expand(B) for s in stats))
    ys = pytree.tree_map(lambda y, a: y.movedim(1, a + 1), ys, axes)
    return ys, stats


def odeint_final(
    f: Callable,
    z0: Any,
    t0: float,
    t1: float,
    args: Any = (),
    **kw,
) -> Tuple[Any, SolveStats]:
    """Integrate [t0, t1] and return only z(t1) (the NODE block's use);
    ``t0 > t1`` runs the solve in reverse time. Takes every ``odeint``
    keyword."""
    leaves, _ = state_leaves(z0)
    ts = torch.tensor([t0, t1], dtype=torch.float32, device=leaves[0].device)
    ys, stats = odeint(f, z0, ts, args, **kw)
    return pytree.tree_map(lambda y: y[-1], ys), stats


class DenseSolution(NamedTuple):
    """A solution to read at any time (``odeint_dense``).

    Every accepted step's interpolant: ``t``/``h`` the intervals' start
    times and stepsizes in internal (ascending) time, ``coeffs`` their
    ``InterpCoeffs`` (leading step axis, the flat state where the solve
    raveled it), ``n`` the valid steps (a host int), ``sign`` +1.0 or
    -1.0 (user time = sign × internal time; -1 for t1 < t0) and
    ``unravel`` the map from a flat (..., N) state back to z0's structure
    (None when the state was solved as it is). Slots past ``n`` are
    unused. Forward only: no gradient flows through it.
    """
    t: torch.Tensor
    h: torch.Tensor
    coeffs: InterpCoeffs
    n: int
    sign: float
    unravel: Optional[Callable] = None

    def evaluate(self, t) -> Any:
        """The state at time(s) ``t``, a scalar or a tensor of any shape
        (the outputs lead with its shape); times outside [t0, t1] clamp to
        the nearest end."""
        tq = torch.as_tensor(t, dtype=self.t.dtype,
                             device=self.t.device) * self.sign
        qshape = tuple(tq.shape)
        tq = tq.reshape(-1)
        knots = self.t[:max(self.n, 1)].contiguous()
        idx = torch.clamp(torch.searchsorted(knots, tq, right=True) - 1,
                          0, max(self.n - 1, 0))
        t_i, h_i = self.t[idx], self.h[idx]
        tiny = torch.finfo(self.t.dtype).eps
        theta = torch.clamp((tq - t_i) / torch.clamp(h_i, min=tiny), 0.0,
                            1.0)
        vals = interp_eval_aligned(InterpCoeffs(*(c[idx]
                                                  for c in self.coeffs)),
                                   theta)
        vals = vals.reshape(qshape + tuple(vals.shape[1:]))
        return vals if self.unravel is None else self.unravel(vals)


def odeint_dense(
    f: Callable,
    z0: Any,
    t0: float,
    t1: float,
    args: Any = (),
    *,
    solver: Union[str, Tableau] = "dopri5",
    rtol: float = 1e-6,
    atol: float = 1e-6,
    max_steps: int = 256,
    max_trials: int = 12,
    use_pallas: bool = False,
) -> Tuple[DenseSolution, SolveStats]:
    """Solve dz/dt = f(t, z, *args) over [t0, t1] once and return a
    ``DenseSolution`` to read at any time.

    The controller advances on its natural grid and every accepted step's
    interpolant is kept (memory 5 × max_steps states), so
    ``sol.evaluate(t)`` is one binary search and one polynomial per query,
    with ``interpolate_ts``'s accuracy. ``t1 < t0`` solves in reverse
    time; ``evaluate`` then takes the user's times. Forward only.
    ``stats.overflow`` means ``max_steps`` ran out before t1 (the solution
    is then valid up to the last accepted step).
    """
    tab = get_tableau(solver) if isinstance(solver, str) else solver
    if not tab.adaptive:
        raise ValueError(
            f"odeint_dense requires an adaptive solver (got {tab.name!r})")
    leaves, _ = state_leaves(z0)
    ts = torch.tensor([float(t0), float(t1)], dtype=torch.float32,
                      device=leaves[0].device)
    sign = 1.0
    if _ts_direction(ts) < 0:
        f, ts, sign = _negate_time(f), -ts, -1.0
    cfg = ControllerConfig(max_steps=max_steps, max_trials=max_trials)
    f, z0, unravel, use_pallas = maybe_flatten(f, z0, use_pallas)
    with torch.no_grad():
        _, ckpts, stats = adaptive_while_solve(
            tab, f, z0, ts, as_tuple(args), rtol, atol, cfg,
            use_pallas=use_pallas, store_coeffs=True)
    sol = DenseSolution(t=ckpts.t, h=ckpts.h, coeffs=ckpts.coeffs,
                        n=ckpts.n, sign=sign, unravel=unravel)
    return sol, stats
