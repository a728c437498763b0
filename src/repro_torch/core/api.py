"""The ``odeint`` front door of the port (adaptive ACA, solo or batched).

Port of ``repro/core/api.py::odeint`` / ``odeint_final`` for one state
tensor::

    ys, stats = odeint(f, z0, ts, args, solver="dopri5", grad_method="aca",
                       rtol=1e-6, atol=1e-6, max_steps=256, max_trials=12,
                       use_pallas=False, h0=None, on_failure="status")

``f(t, z, *args) -> dz/dt``; ``ts`` strictly monotone — ascending, or
descending for a reverse-time solve (solved as the time-negated ascending
problem); ``ys[k] = z(ts[k])`` with ``ys[0] = z0``. The solve runs on
``z0``'s device; ``ts`` moves there. Gradients flow to ``z0`` and to the
floating tensors of ``args`` through the ACA backward sweep.

``batch_axis=a`` solves every slice of ``z0`` along axis ``a`` as its own
problem (``f`` is the per-sample field), each on its own adaptive grid;
``ys[k]`` keeps the batch at axis ``a`` and ``stats`` fields are (B,).
There ``rtol``/``atol`` may be (B,) arrays, one tolerance per row, and
``h0`` a (B,) array::

    ys, stats = odeint(f, z0, ts, args, batch_axis=0,
                       rtol=torch.tensor([1e-3, 1e-5]), atol=1e-6)

Options of later slices keep the reference's signature and raise a
``ValueError`` naming the slice (ROADMAP queue 1) that brings them.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple, Union

import numpy as np
import torch

from .controller import ControllerConfig
from .integrate import SolveStats
from .odeint_aca import odeint_aca, odeint_aca_batched
from .tableaus import Tableau, get_tableau

GRAD_METHODS = ("aca",)

ON_FAILURE_POLICIES = ("status",)


def _later(what: str, slice_: str) -> ValueError:
    return ValueError(
        f"{what} is not ported yet: it comes with {slice_} (ROADMAP queue 1)")


def _ts_direction(ts: torch.Tensor) -> int:
    """+1 for strictly ascending ``ts``, -1 for strictly descending;
    ValueError for anything else (repeated times included)."""
    d = ts[1:] - ts[:-1]
    if bool((d > 0).all()):
        return 1
    if bool((d < 0).all()):
        return -1
    raise ValueError(
        "ts must be strictly monotone: ascending (forward solve) or "
        "descending (reverse-time solve); got neither — sort your eval "
        "times (and deduplicate repeats) before calling odeint")


def _negate_time(f: Callable) -> Callable:
    """dz/ds = -f(-s, z) over ascending s = -t is the reverse-time solve
    over descending t."""
    def f_neg(s, z, *a):
        return -f(-s, z, *a)

    return f_neg


def odeint(
    f: Callable,
    z0: torch.Tensor,
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
) -> Tuple[torch.Tensor, SolveStats]:
    """Solve dz/dt = f(t, z, *args) through ``ts``; see the module
    docstring.

    ``max_steps`` caps the accepted steps (the checkpoint capacity;
    ``stats.overflow`` is set when the solve runs out before the last
    eval time) and ``max_trials`` the stepsize search per step.
    ``use_pallas=True`` flattens the state once per solve and runs every
    trial's stage sums and error norm through kernels K1 and K2, or K3
    and K4/K5 under ``batch_axis`` (their plain versions for a CPU
    state). ``h0`` overrides the initial-stepsize heuristic.
    ``stats.status`` carries a ``SolveStatus`` code
    (``on_failure="status"``). ``steps_per_interval`` and
    ``trial_budget`` belong to the fixed-grid and naive methods and are
    not read yet.
    """
    if grad_method == "adjoint" or grad_method == "naive":
        raise _later(f"grad_method={grad_method!r}", "slice B")
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
    if not isinstance(z0, torch.Tensor):
        raise ValueError(
            f"z0 must be one torch.Tensor; got {type(z0).__name__}. Pytree "
            "(nested) states are not ported yet: they come with the "
            "remainder of slice A (ROADMAP queue 1)")
    rtol, atol = _tolerances(rtol, atol, batch_axis, mesh, tab, z0.device)
    if mesh is not None or shard_rules is not None:
        raise _later("mesh / shard_rules (sharded solving)", "slice I")
    if checkpoint_segments is not None:
        raise _later("checkpoint_segments (segmented ACA)", "slice D")
    if interpolate_ts:
        raise _later("interpolate_ts (dense output)", "slice D")
    if not tab.adaptive:
        raise _later(f"fixed-grid solver {tab.name!r}", "slice B")

    ts = torch.as_tensor(ts, device=z0.device)
    if not ts.is_floating_point():
        ts = ts.to(torch.float32)
    if ts.dim() != 1 or ts.shape[0] < 2:
        raise ValueError("ts must be a 1D array of at least 2 times")
    if _ts_direction(ts) < 0:
        # reverse time: solve the time-negated problem over ascending -ts
        f, ts = _negate_time(f), -ts

    cfg = ControllerConfig(max_steps=max_steps, max_trials=max_trials)
    if h0 is not None:
        h0 = torch.as_tensor(h0, dtype=ts.dtype, device=z0.device)
    if batch_axis is not None:
        return _odeint_batched(f, z0, ts, args, tab=tab,
                               batch_axis=batch_axis, rtol=rtol, atol=atol,
                               cfg=cfg, h0=h0, use_pallas=use_pallas)
    return odeint_aca(f, z0, ts, args, solver=tab, rtol=rtol, atol=atol,
                      cfg=cfg, h0=h0, use_pallas=use_pallas)


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


def _odeint_batched(f: Callable, z0: torch.Tensor, ts: torch.Tensor,
                    args: Any, *, tab: Tableau, batch_axis: int, rtol, atol,
                    cfg: ControllerConfig, h0: Optional[torch.Tensor],
                    use_pallas: bool) -> Tuple[torch.Tensor, SolveStats]:
    """``odeint(..., batch_axis=a)``: moves the batch to axis 0, solves
    every row on its own grid (``odeint_aca_batched``) and moves the batch
    back in ``ys``, where it sits one axis deeper under the time axis."""
    if z0.dim() == 0:
        raise ValueError(
            f"batch_axis={batch_axis} requires the state to carry a batch "
            "dimension, but it is rank-0 (a scalar has no axis to batch "
            "over)")
    ax = batch_axis % z0.dim()
    B = z0.shape[ax]
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
    z0 = z0.movedim(ax, 0)
    ys, stats = odeint_aca_batched(f, z0, ts, args, solver=tab, rtol=rtol,
                                   atol=atol, cfg=cfg, h0=h0,
                                   use_pallas=use_pallas)
    return ys.movedim(1, ax + 1), stats


def odeint_final(
    f: Callable,
    z0: torch.Tensor,
    t0: float,
    t1: float,
    args: Any = (),
    **kw,
) -> Tuple[torch.Tensor, SolveStats]:
    """Integrate [t0, t1] and return only z(t1) (the NODE block's use);
    ``t0 > t1`` runs the solve in reverse time. Takes every ``odeint``
    keyword."""
    if not isinstance(z0, torch.Tensor):
        raise ValueError(
            f"z0 must be one torch.Tensor; got {type(z0).__name__}")
    ts = torch.tensor([t0, t1], dtype=torch.float32, device=z0.device)
    ys, stats = odeint(f, z0, ts, args, **kw)
    return ys[-1], stats
