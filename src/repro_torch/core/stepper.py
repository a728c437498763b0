"""Generic explicit Runge-Kutta step ψ_h(t, z) over a state tensor.

Port of ``repro/core/stepper.py`` for one state tensor (any shape). Two
execution paths, selected per call, with the same f32 arithmetic in the
same accumulation order:

* **Flat fused path** (``use_pallas=True`` and a 1-D floating state): each
  stage argument z + h·Σ a_ij k_j is kernel K1 and the solution/error
  combine with its scaled error norm is kernel K2
  (``repro_torch.kernels``); the norm comes back as
  ``StepResult.err_ratio``. On a CPU tensor the kernels' plain versions
  run instead. ``flatten_problem`` reshapes a state of any shape to (N,)
  once per solve.
* **Plain-tensor path** (default): tensor arithmetic on the state as it
  is; callers compute ``error_ratio`` themselves.

Pytree (nested) states belong to a later slice and raise ``ValueError``.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from ..kernels import ops
from .tableaus import Tableau

VecField = Callable[..., torch.Tensor]  # f(t, z, *args) -> dz/dt


def check_state(z0: Any) -> None:
    """The state of this slice is one floating tensor."""
    if not isinstance(z0, torch.Tensor):
        raise ValueError(
            f"the state must be one torch.Tensor; got {type(z0).__name__}. "
            "Pytree (nested) states are not ported yet: they come with the "
            "remainder of slice A (ROADMAP queue 1)")
    if not z0.is_floating_point():
        raise ValueError(f"the state must be floating; got {z0.dtype}")


def _promoted(h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x cast so that ``h * x`` computes in JAX's promoted dtype (a 0-d
    f32 stepsize times a bf16 tensor is f32 there, bf16 in torch)."""
    return x.to(torch.promote_types(h.dtype, x.dtype))


def _axpy(alpha: torch.Tensor, x: torch.Tensor,
          y: torch.Tensor) -> torch.Tensor:
    """y + alpha * x, rounded to y's dtype (an f32 stepsize must not
    upcast a bf16 state)."""
    return y + (alpha * _promoted(alpha, x)).to(y.dtype)


def _weighted_sum(ks, ws) -> torch.Tensor:
    """Σ_i ws[i] * ks[i], skipping exact-zero weights."""
    acc = None
    for w, k in zip(ws, ks):
        if w == 0.0:
            continue
        term = w * k
        acc = term if acc is None else acc + term
    if acc is None:
        acc = torch.zeros_like(ks[0])
    return acc


class StepResult(NamedTuple):
    z_next: torch.Tensor
    err: Optional[torch.Tensor]   # local error estimate (None if not formed)
    k_last: torch.Tensor          # last stage derivative (FSAL reuse)
    # scaled error norm from the fused kernel (flat path with err_scale
    # only); None -> the caller computes error_ratio itself
    err_ratio: Optional[torch.Tensor] = None


def _is_flat(z: torch.Tensor) -> bool:
    return z.dim() == 1 and z.is_floating_point()


def flatten_problem(f: VecField, z0: torch.Tensor):
    """Per-solve flat-state adapter for the fused kernel path.

    Returns ``(f_flat, z0_flat, unravel)``: the vector field over the
    (N,) state, the flattened initial state, and ``unravel`` mapping a
    (..., N) tensor back to (..., *z0.shape).
    """
    check_state(z0)
    shape = tuple(z0.shape)

    def f_flat(t, zf, *args):
        return f(t, zf.reshape(shape), *args).reshape(-1)

    def unravel(x):
        return x.reshape(tuple(x.shape[:-1]) + shape)

    return f_flat, z0.reshape(-1), unravel


def maybe_flatten(f: VecField, z0: torch.Tensor, use_pallas: bool):
    """``(f, z0, unravel, use_pallas)``: the flat problem when the fused
    path is requested, else the inputs unchanged with ``unravel=None``."""
    check_state(z0)
    if not use_pallas:
        return f, z0, None, False
    f_flat, z0_flat, unravel = flatten_problem(f, z0)
    return f_flat, z0_flat, unravel, True


def _rk_step_flat(tab: Tableau, f: VecField, t, z: torch.Tensor, h,
                  args: Tuple, k0: Optional[torch.Tensor],
                  err_scale: Optional[Tuple[float, float]]) -> StepResult:
    """Fused-kernel ψ over a flat (N,) state (see module docstring)."""
    k0v = k0 if k0 is not None else f(t, z, *args)
    stages = [k0v]
    # Without autograd the stage derivatives go into one (s, N) buffer the
    # kernels read in place. Under autograd (the ACA replay) each kernel
    # call gets its own stacked copy, since the kernels' backward keeps
    # its k input and a later in-place write would invalidate it.
    ks = None
    if not torch.is_grad_enabled():
        ks = torch.empty((tab.stages,) + tuple(z.shape), dtype=k0v.dtype,
                         device=z.device)
        ks[0] = k0v

    def rows(i):
        return ks[:i] if ks is not None else torch.stack(stages[:i])

    for i in range(1, tab.stages):
        zi = ops.rk_stage_increment(z, rows(i), h, tab.a[i])
        ki = f(t + tab.c[i] * h, zi, *args)
        if ks is not None:
            ks[i] = ki
        stages.append(ki)

    ratio = None
    if tab.b_err is not None and err_scale is not None:
        rtol, atol = err_scale
        # with_err=False: the accept/reject loop reads only z_next and the
        # fused norm, so the (N,) err buffer is never written
        z_next, err, sq_sum = ops.rk_stage_combine_err(
            z, rows(tab.stages), h, tab.b, tab.b_err, rtol, atol,
            with_err=False)
        ratio = torch.sqrt(sq_sum / torch.full_like(sq_sum, z.numel()))
    else:
        # no consumer for err here (the ACA replay reads only z_next): the
        # solution combine is K1 with the b row, without the err store
        z_next = ops.rk_stage_increment(z, rows(tab.stages), h, tab.b)
        err = None
    k_last = stages[-1] if tab.fsal else stages[0]
    return StepResult(z_next=z_next, err=err, k_last=k_last, err_ratio=ratio)


def rk_step(tab: Tableau, f: VecField, t, z: torch.Tensor, h,
            args: Tuple = (), k0: Optional[torch.Tensor] = None, *,
            use_pallas: bool = False,
            err_scale: Optional[Tuple[float, float]] = None) -> StepResult:
    """One explicit RK step of ``tab`` from (t, z) with stepsize h.

    ``k0`` optionally supplies the first stage derivative (FSAL). Returns
    z_{n+1}, the embedded error estimate h·Σ b_err_i k_i and the final
    stage derivative for FSAL chaining. ``use_pallas=True`` dispatches a
    1-D floating state to the fused kernels; there, with ``err_scale=(rtol,
    atol)``, the result carries the scaled error norm in ``err_ratio``,
    and without it ``err`` is None even for embedded tableaus.
    """
    if use_pallas and _is_flat(z):
        return _rk_step_flat(tab, f, t, z, h, args, k0, err_scale)
    ks = []
    for i in range(tab.stages):
        if i == 0:
            ki = k0 if k0 is not None else f(t, z, *args)
        else:
            zi = _axpy(h, _weighted_sum(ks, tab.a[i]), z)
            ki = f(t + tab.c[i] * h, zi, *args)
        ks.append(ki)

    z_next = _axpy(h, _weighted_sum(ks, tab.b), z)
    err = None
    if tab.b_err is not None:
        e = _weighted_sum(ks, tab.b_err)
        err = h * _promoted(h, e)
    k_last = ks[-1] if tab.fsal else ks[0]
    return StepResult(z_next=z_next, err=err, k_last=k_last)


def error_ratio(err: torch.Tensor, z0: torch.Tensor, z1: torch.Tensor,
                rtol: float, atol: float) -> torch.Tensor:
    """RMS norm of err scaled by atol + rtol*max(|z0|,|z1|) (Hairer I.4).

    Returns a 0-d f32 tensor; an accepted step has ratio <= 1.
    """
    scale = atol + rtol * torch.maximum(torch.abs(z0), torch.abs(z1))
    r = (err / scale).float()
    total = torch.sum(r * r)
    return torch.sqrt(total / torch.full_like(total, r.numel()))
