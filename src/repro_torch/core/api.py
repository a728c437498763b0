"""The ``odeint`` front door of the port: ACA, adjoint and naive
gradients, adaptive and fixed grids, solo or batched.

Port of ``repro/core/api.py::odeint`` / ``odeint_final``::

    ys, stats = odeint(f, z0, ts, args, solver="dopri5", grad_method="aca",
                       rtol=1e-6, atol=1e-6, max_steps=256, max_trials=12,
                       steps_per_interval=8, trial_budget=None,
                       use_pallas=False, checkpoint_segments=None,
                       interpolate_ts=False, h0=None, on_failure="status")

``f(t, z, *args) -> dz/dt``; ``z0`` one floating tensor or a pytree
(dict, tuple, list, NamedTuple) of floating tensors, raveled once per
solve (leaves of several dtypes into one flat tensor per dtype, each
leaf computing in its own dtype; such a state takes no kernel); ``ts``
strictly monotone — ascending, or descending for a reverse-time solve
(solved as the time-negated ascending problem); ``ys[k] = z(ts[k])``
with ``ys[0] = z0`` (``ys`` has z0's structure, each leaf stacked over
``ts`` in its own dtype). The solve runs on ``z0``'s device; ``ts``
moves there. Gradients flow to ``z0`` and to the floating tensors of
``args``.

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
``DenseSolution`` to read at any time.

``grad_method="mali"`` pairs with ``solver="alf"`` (its default): the
reversible asynchronous-leapfrog pair stepper, whose backward inverts the
accepted steps from the terminal pair, so no state is stored per step
(``odeint_mali``); it takes neither ``checkpoint_segments`` nor
``interpolate_ts``.

Solve health: every adaptive solve guards its trials against non-finite
states; a poisoned solve (or batch row) freezes at its last accepted
state with finite outputs and zero cotangents, and ``stats.status``
carries its ``SolveStatus`` code. ``on_failure`` picks the policy:
``"status"`` (report only, no extra host read), ``"warn"`` (a
``RuntimeWarning`` naming the codes) or ``"raise"`` (``SolveFailedError``;
``odeint_checked``). ``solve_with_fallback`` retries a failed solve down
``default_fallback_ladder``.

Sharded solving: ``mesh=`` (a torch ``DeviceMesh``, with ``batch_axis``)
splits the batched solve over the mesh's data dims (``shard_rules``, an
``AxisRules``, remaps them). Every rank calls ``odeint`` with the same
global inputs; each solves its contiguous block of rows with its own
trial counts, and every rank returns the global ``ys`` and stats, the
unsharded solve's bit for bit; the shared ``args`` gradient is summed
over the shards once, after the solve's backward
(``repro_torch.distributed``)::

    init_distributed("cuda")            # repro_torch.launch.mesh
    ys, stats = odeint(f, z0, ts, args, batch_axis=0, mesh=shard_mesh())
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch.func import vmap
from torch.utils import _pytree as pytree

from .controller import ControllerConfig
from .groups import gget, gmap
from .integrate import SolveStats, SolveStatus, adaptive_while_solve, as_tuple
from .odeint_aca import odeint_aca, odeint_aca_batched, odeint_aca_fixed
from .odeint_adjoint import (
    odeint_adjoint,
    odeint_adjoint_batched,
    odeint_adjoint_fixed,
)
from .odeint_mali import odeint_mali, odeint_mali_batched
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

GRAD_METHODS = ("aca", "adjoint", "naive", "mali")

ON_FAILURE_POLICIES = ("status", "warn", "raise")

_ADAPTIVE = {"aca": odeint_aca, "adjoint": odeint_adjoint,
             "naive": odeint_naive, "mali": odeint_mali}
_BATCHED = {"aca": odeint_aca_batched, "adjoint": odeint_adjoint_batched,
            "naive": odeint_naive_batched, "mali": odeint_mali_batched}
_FIXED = {"aca": odeint_aca_fixed, "adjoint": odeint_adjoint_fixed,
          "naive": odeint_naive_fixed}


class SolveFailedError(RuntimeError):
    """A solve under ``on_failure="raise"`` (``odeint_checked``) ended with
    a ``SolveStatus`` other than OK; the message names the codes."""


def _failure_message(stats: SolveStats, what: str) -> Optional[str]:
    """None for a healthy solve, else ``what`` with the status codes and
    their names (one host read of ``stats.status``)."""
    status = stats.status.tolist()
    codes = sorted({c for c in np.ravel(status).tolist()
                    if c != SolveStatus.OK})
    if not codes:
        return None
    names = ", ".join(SolveStatus.describe(c) for c in codes)
    return (f"odeint: {what}, status={status} ({names}; see "
            "repro_torch.core.SolveStatus.describe)")


def _apply_on_failure(ys, stats: SolveStats, on_failure: str):
    """The solve-health policy on a finished solve. ``"status"`` returns
    at once (callers read ``stats.status``; no host read); ``"warn"``
    reads the status once and warns (``RuntimeWarning``) when any solve or
    row failed; ``"raise"`` raises ``SolveFailedError`` there."""
    if on_failure == "status":
        return ys, stats
    if on_failure == "warn":
        msg = _failure_message(stats, "solve-health failure")
        if msg is not None:
            warnings.warn(msg, RuntimeWarning, stacklevel=3)
        return ys, stats
    msg = _failure_message(stats, "solve failed")
    if msg is not None:
        raise SolveFailedError(msg)
    return ys, stats


def _is_alf(solver) -> bool:
    """True when ``solver`` names the reversible asynchronous-leapfrog pair
    integrator, the only solver ``grad_method='mali'`` takes (it is not an
    RK tableau)."""
    return (isinstance(solver, str)
            and solver.lower().replace("-", "_") == "alf")


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
    group: Optional[Any] = None,
    _direction: Optional[int] = None,
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
    solver (or of ``"alf"``). ``stats.status`` carries a ``SolveStatus``
    code; ``on_failure`` (``"status"``, ``"warn"``, ``"raise"``), the
    ``"mali"`` method, ``checkpoint_segments`` (ACA with an adaptive
    solver), ``interpolate_ts`` (adaptive solvers) and ``mesh`` /
    ``shard_rules`` (with ``batch_axis``, a 1D ``ts`` and scalar
    tolerances) as in the module docstring.

    ``group`` (a ``distributed.regions.SolveGroup``; no ``batch_axis``)
    declares ``z0`` this rank's block of a state split over the group's
    ranks, each rank calling ``odeint`` on its block with the same ``ts``
    and ``args``: every reduction the solver makes (error norms, the
    initial stepsize, the non-finite guard, the MALI lattice's scale, a
    fixed grid's status) is the whole state's, so every rank takes the
    same trials and returns the same stats (a NODE block on
    ``RunConfig.mesh``). ``_direction`` is ``odeint_final``'s: the sign of
    its float endpoints, in place of reading ``ts``.
    """
    if grad_method not in GRAD_METHODS:
        raise ValueError(f"grad_method must be one of {GRAD_METHODS}")
    if on_failure not in ON_FAILURE_POLICIES:
        raise ValueError(
            f"on_failure must be one of {ON_FAILURE_POLICIES}; got "
            f"{on_failure!r}")
    mali = grad_method == "mali"
    if solver is None:
        # mali integrates with the ALF pair stepper; every other method
        # defaults to the paper's Dopri5
        solver = "alf" if mali else "dopri5"
    if mali and not _is_alf(solver):
        name = solver if isinstance(solver, str) else solver.name
        raise ValueError(
            f"grad_method='mali' integrates with the reversible "
            f"asynchronous-leapfrog pair stepper (solver='alf'), not an "
            f"RK tableau (got {name!r}); drop the solver argument or "
            "pass solver='alf'")
    if _is_alf(solver) and not mali:
        raise ValueError(
            f"solver='alf' is the reversible pair integrator whose "
            f"inverse IS the gradient method — it pairs only with "
            f"grad_method='mali' (got {grad_method!r})")
    tab = None if mali else (
        get_tableau(solver) if isinstance(solver, str) else solver)
    leaves, _ = state_leaves(z0)
    device = leaves[0].device
    if checkpoint_segments is not None and mali:
        raise ValueError(
            "checkpoint_segments is meaningless with grad_method='mali': "
            "MALI keeps no state checkpoints at all — its backward sweep "
            "reconstructs every state by inverting steps from the "
            "terminal pair in O(1) memory; drop checkpoint_segments")
    if checkpoint_segments is not None and (
            grad_method != "aca" or not tab.adaptive):
        raise ValueError(
            "checkpoint_segments requires grad_method='aca' with an "
            f"adaptive solver (got {grad_method!r} / {tab.name!r}): only "
            "the ACA trajectory checkpoint stores per-step states to "
            "segment")
    if interpolate_ts and mali:
        raise ValueError(
            "interpolate_ts is not supported with grad_method='mali': "
            "the reversible backward sweep reconstructs exact step "
            "landings only (no interpolant cotangent routing); use "
            "grad_method='aca' for dense-output gradients")
    if interpolate_ts and not tab.adaptive:
        raise ValueError(
            "interpolate_ts requires an adaptive solver (got "
            f"{tab.name!r}): fixed grids land on every eval time by "
            "construction, there is no stepsize search to relieve")
    if h0 is not None and not mali and not tab.adaptive:
        raise ValueError(
            f"h0 overrides the adaptive initial-stepsize heuristic; "
            f"fixed-grid solver {tab.name!r} has no stepsize controller "
            "— use steps_per_interval to refine its grid instead")
    if group is not None and (batch_axis is not None or mesh is not None):
        raise ValueError(
            "group declares z0 one rank's block of a split state, solved "
            "on the whole state's grid; a batch_axis solve keeps whole rows "
            "on a rank (and mesh splits them itself): drop group")
    if mesh is not None:
        if batch_axis is None:
            raise ValueError(
                "mesh requires batch_axis: sharding distributes the "
                "per-sample batched solve over the mesh's data axes, so the "
                "state must carry a batch dimension — pass batch_axis=a "
                "(or drop mesh for a single-sample solve)")
        mesh_type = getattr(mesh, "device_type", None)
        if mesh_type is None or not hasattr(mesh, "mesh_dim_names"):
            raise ValueError(
                "mesh must be a torch DeviceMesh with named dimensions "
                "(repro_torch.distributed.shard_mesh, repro_torch.launch."
                f"mesh); got {type(mesh).__name__}")
        if mesh_type != device.type:
            raise ValueError(
                f"the mesh's device type {mesh_type!r} does not match the "
                f"state's device {str(device)!r}: build the mesh for the "
                "device z0 lives on (shard_mesh(device_type=...))")
    rtol, atol = _tolerances(rtol, atol, batch_axis, mesh, tab, device)

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
    if (_ts_direction(ts) if _direction is None else _direction) < 0:
        # reverse time: solve the time-negated problem over ascending -ts
        f, ts = _negate_time(f), -ts

    cfg = ControllerConfig(max_steps=max_steps, max_trials=max_trials)
    if h0 is not None:
        h0 = torch.as_tensor(h0, dtype=ts.dtype, device=device)
    if batch_axis is not None:
        ys, stats = _odeint_batched(
            f, z0, ts, args, tab=tab, grad_method=grad_method,
            batch_axis=batch_axis, rtol=rtol, atol=atol, cfg=cfg,
            steps_per_interval=steps_per_interval, trial_budget=trial_budget,
            h0=h0, use_pallas=use_pallas,
            checkpoint_segments=checkpoint_segments,
            interpolate_ts=interpolate_ts, mesh=mesh,
            shard_rules=shard_rules)
    elif not mali and not tab.adaptive:
        # the adjoint takes the group for its field's products
        kw = {} if group is None or grad_method != "adjoint" else \
            {"group": group}
        ys, stats = _FIXED[grad_method](
            f, z0, ts, args, solver=tab,
            steps_per_interval=steps_per_interval, use_pallas=use_pallas,
            **kw)
        if group is not None:
            # a fixed grid's status is the whole state's
            stats = stats._replace(status=group.max(stats.status))
    else:
        kw = {} if group is None else {"group": group}
        ys, stats = _ADAPTIVE[grad_method](
            f, z0, ts, args, rtol=rtol, atol=atol, cfg=cfg, h0=h0,
            use_pallas=use_pallas,
            **_method_kw(grad_method, tab, trial_budget, checkpoint_segments,
                         interpolate_ts), **kw)
    return _apply_on_failure(ys, stats, on_failure)


def _method_kw(grad_method: str, tab: Optional[Tableau],
               trial_budget: Optional[int], checkpoint_segments,
               interpolate_ts: bool) -> dict:
    """The keywords one adaptive gradient method takes beyond the common
    ones (mali has no tableau and no dense output)."""
    if grad_method == "mali":
        return {}
    kw = dict(solver=tab, interpolate_ts=interpolate_ts)
    if grad_method == "naive":
        kw.update(trial_budget=trial_budget)
    elif grad_method == "aca":
        kw.update(checkpoint_segments=checkpoint_segments)
    return kw


def _tolerances(rtol, atol, batch_axis, mesh, tab: Optional[Tableau],
                device):
    """Floats, or (under ``batch_axis``) rank-1 f32 tensors on ``device``
    when either tolerance is an array: one tolerance per batch row. Raises
    the reference's named errors for array tolerances elsewhere (``tab``
    None is mali's ALF, adaptive)."""
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
    if tab is not None and not tab.adaptive:
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
                    tab: Optional[Tableau], grad_method: str,
                    batch_axis: int, rtol,
                    atol, cfg: ControllerConfig, steps_per_interval: int,
                    trial_budget: Optional[int], h0: Optional[torch.Tensor],
                    use_pallas: bool, checkpoint_segments=None,
                    interpolate_ts: bool = False, mesh: Optional[Any] = None,
                    shard_rules: Optional[Any] = None
                    ) -> Tuple[Any, SolveStats]:
    """``odeint(..., batch_axis=a)``: moves the batch to axis 0 of every
    state leaf, routes adaptive tableaus and mali (``tab`` None) to the
    per-sample batched solvers and fixed grids to the shared grid with the
    field vmapped over the batch, and moves the batch back in ``ys``, where
    it sits one axis deeper under the time axis. With ``mesh`` the
    dispatch runs on this rank's rows (``_shard_solve``)."""
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
        if mesh is not None:
            raise ValueError(
                "per-row (B, T) ts do not compose with mesh: the reference's "
                "sharded solve replicates ts and takes a 1D ts only — pass "
                "one 1D ts (the union of the rows' times, "
                "data.merged_time_grid) or drop mesh")
        if ts.shape[0] != B:
            raise ValueError(
                f"per-row ts must carry one row of eval times per batch "
                f"row (B={B}); got shape {tuple(ts.shape)}")
        if tab is not None and not tab.adaptive:
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

    def dispatch(z0, args, h0):
        # the batch leads dim 0 of every z0 leaf; under a mesh this runs
        # on this rank's rows
        if tab is None or tab.adaptive:
            return _BATCHED[grad_method](
                f, z0, ts, args, rtol=rtol, atol=atol, cfg=cfg, h0=h0,
                use_pallas=use_pallas,
                **_method_kw(grad_method, tab, trial_budget,
                             checkpoint_segments, interpolate_ts))

        # a fixed grid is the same for every row: lockstep is the
        # per-sample grid, so the batch runs as one system
        def fb(t, z, *a):
            return vmap(lambda zi: f(t, zi, *a))(z)

        ys, stats = _FIXED[grad_method](
            fb, z0, ts, args, solver=tab,
            steps_per_interval=steps_per_interval, use_pallas=use_pallas)
        b = state_leaves(z0)[0][0].shape[0]
        return ys, SolveStats(*(s.expand(b) for s in stats))

    if mesh is None:
        ys, stats = dispatch(z0, args, h0)
    else:
        ys, stats = _shard_solve(dispatch, mesh, shard_rules, z0, args, h0,
                                 B)
    ys = pytree.tree_map(lambda y, a: y.movedim(1, a + 1), ys, axes)
    return ys, stats


def _shard_solve(dispatch: Callable, mesh, shard_rules, z0: Any, args: Any,
                 h0: Optional[torch.Tensor], B: int
                 ) -> Tuple[Any, SolveStats]:
    """Run the batch-at-dim-0 ``dispatch`` on this rank's rows.

    The counterpart of the reference's ``_shard_map_solve`` in torch's
    process-per-rank form: every rank holds the global inputs, takes its
    contiguous block of rows of ``z0`` (and of a (B,) ``h0``) by its
    coordinates on the mesh's batch dims, solves them with its own trip
    counts, and all-gathers ``ys`` (batch at dim 1) and the stats over the
    batch dims' group, so every rank returns the global result. ``ts``
    and ``args`` are replicated; the ``args`` cotangent is summed over the
    batch group once, after the shard's backward (``distributed.
    collectives``: two collectives forward, two backward, none inside a
    trial loop).
    """
    from ..distributed.collectives import BatchShard
    from ..distributed.sharding import batch_partition_axes, mesh_shape

    axes = batch_partition_axes(mesh, shard_rules)
    shape = tuple(mesh_shape(mesh).items())
    if not axes:
        raise ValueError(
            f"mesh {shape} has no data-parallel axis to shard the batch "
            "over (the sharding rules map 'batch' to ('pod', 'data'), none "
            "of which the mesh carries) — add a 'data' axis, use "
            "repro_torch.distributed.shard_mesh(), or pass shard_rules "
            "mapping 'batch' onto one of this mesh's axes")
    n_shard = 1
    for a in axes:
        n_shard *= dict(shape)[a]
    if B % n_shard:
        raise ValueError(
            f"batch size {B} does not divide evenly over the mesh's "
            f"{n_shard} batch shard(s) (axes {axes} of mesh {shape}): pad "
            f"the batch to a multiple of {n_shard} or drop devices from the "
            "mesh")
    shard = BatchShard(mesh, axes, B)
    if h0 is not None and tuple(h0.shape) == (B,) and B > 1:
        h0 = h0.narrow(0, shard.lo, shard.rows)
    ys, stats = dispatch(shard.take(z0), shard.replicate(args), h0)
    return shard.gather(ys, dim=1), SolveStats(*shard.gather_rows(
        list(stats), 0))


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
    keyword. With a ``group`` the direction comes from the floats: the
    block's ``ts`` may be a fake tensor (a dry run), which no host read
    can take."""
    leaves, _ = state_leaves(z0)
    ts = torch.tensor([t0, t1], dtype=torch.float32, device=leaves[0].device)
    if kw.get("group") is not None and t0 != t1:
        kw["_direction"] = 1 if t1 > t0 else -1
    ys, stats = odeint(f, z0, ts, args, **kw)
    return pytree.tree_map(lambda y: y[-1], ys), stats


def odeint_checked(f: Callable, z0: Any, ts, args: Any = (),
                   **kw) -> Tuple[Any, SolveStats]:
    """``odeint`` that raises on a failed solve instead of returning a
    status code: ``odeint(..., on_failure="raise")``. A non-finite state,
    a stepsize underflow or a spent budget raises ``SolveFailedError``
    naming the status codes. Takes every ``odeint`` keyword but
    ``on_failure``."""
    kw.pop("on_failure", None)
    return odeint(f, z0, ts, args, on_failure="raise", **kw)


def default_fallback_ladder(ts, *, rtol: float = 1e-6,
                            atol: float = 1e-6) -> list:
    """The rungs ``solve_with_fallback`` tries after a failed solve,
    mildest first, each a dict of ``odeint`` keyword overrides with a
    ``"note"``: (1) a first step of span/1024; (2) tolerances loosened
    100×; (3) the lower-order ``bosh3`` pair with ACA gradients; (4) a
    fixed ``rk4`` grid of 64 steps an interval, with no stepsize search
    left to fail."""
    span = abs(float(ts[-1]) - float(ts[0]))
    return [
        {"note": "tighten h0", "h0": span / 1024.0},
        {"note": "loosen tolerances 100x",
         "rtol": rtol * 100.0, "atol": atol * 100.0},
        {"note": "fall back to bosh3/aca",
         "solver": "bosh3", "grad_method": "aca"},
        {"note": "fixed rk4 grid", "solver": "rk4", "grad_method": "aca",
         "steps_per_interval": 64},
    ]


# odeint keywords only adaptive solvers take: dropped from a rung that
# falls back to a fixed-grid tableau
_ADAPTIVE_ONLY_KW = ("h0", "checkpoint_segments", "interpolate_ts",
                     "trial_budget")


def _all_finite(ys) -> bool:
    return all(bool(torch.isfinite(leaf).all())
               for leaf in pytree.tree_leaves(ys))


def solve_with_fallback(f: Callable, z0: Any, ts, args: Any = (), *,
                        ladder: Optional[list] = None,
                        **kw) -> Tuple[Any, SolveStats, list]:
    """Retry a failed solve under ever more conservative settings.

    Runs ``odeint(f, z0, ts, args, **kw)`` and reads ``stats.status`` on
    the host; while any solve (or row) is unhealthy or an output is not
    finite, walks ``ladder`` (default ``default_fallback_ladder``) until an
    attempt comes back all OK. Returns ``(ys, stats, report)``, one report
    dict per attempt (note, overrides, status, ok; error instead of
    status for an attempt that raised). If no rung recovers, the first
    attempt's (frozen, finite) outputs come back with every ``ok`` False;
    if every attempt raised, ``RuntimeError``. Each status read is a host
    synchronization: a serving-layer tool, not a training-step one (there,
    ``on_failure="status"`` and the train loop's skip guard).
    """
    kw.pop("on_failure", None)
    if ladder is None:
        ladder = default_fallback_ladder(
            torch.as_tensor(ts), rtol=kw.get("rtol", 1e-6),
            atol=kw.get("atol", 1e-6))
    report: list = []
    first = None
    for rung in [{"note": "original"}] + list(ladder):
        over = {k: v for k, v in rung.items() if k != "note"}
        akw = {**kw, **over}
        solver = akw.get("solver")
        if solver is not None and not _is_alf(solver):
            tabl = get_tableau(solver) if isinstance(solver, str) else solver
            if not tabl.adaptive:
                for k in _ADAPTIVE_ONLY_KW:
                    akw.pop(k, None)
        entry = {"note": rung.get("note", "attempt"), "overrides": over}
        try:
            ys, stats = odeint(f, z0, ts, args, **akw)
        except Exception as e:  # a rung invalid for this configuration
            entry.update(error=repr(e), ok=False)
            report.append(entry)
            continue
        status = stats.status.tolist()
        ok = (not any(np.ravel(status).tolist())) and _all_finite(ys)
        entry.update(status=status, ok=ok)
        report.append(entry)
        if first is None:
            first = (ys, stats)
        if ok:
            return ys, stats, report
    if first is None:
        raise RuntimeError(
            f"solve_with_fallback: every attempt errored: {report}")
    ys, stats = first
    return ys, stats, report


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
        vals = interp_eval_aligned(InterpCoeffs(*(gget(c, idx)
                                                  for c in self.coeffs)),
                                   theta)
        vals = gmap(lambda v: v.reshape(qshape + tuple(v.shape[1:])), vals)
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
