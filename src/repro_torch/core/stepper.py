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

``rk_step_batched`` is the per-sample form over a state with a leading
batch dimension B: per-row times and stepsizes (B,), the per-sample
field evaluated over the batch with ``torch.func.vmap``, per-row error
norms, and kernels K3 and K4/K5 on the flat (B, N) path.

Pytree (nested) states belong to a later slice and raise ``ValueError``.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import torch
from torch.func import vmap

from ..kernels import ops
from .tableaus import Tableau

VecField = Callable[..., torch.Tensor]  # f(t, z, *args) -> dz/dt
Tol = Union[float, torch.Tensor]        # scalar, or (B,) under batching


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


# ------------------------------------------------------------ batched form

def _is_flat_batched(z: torch.Tensor) -> bool:
    return z.dim() == 2 and z.is_floating_point()


def maybe_flatten_batched(f: VecField, z0: torch.Tensor, use_pallas: bool):
    """Batched twin of ``maybe_flatten``: ``z0`` carries a leading batch
    dimension B and ``f`` is the *per-sample* field.

    Returns ``(f, z0, unravel, use_pallas)``: with the fused path, ``f``
    is the per-sample field over the flat (N,) state, ``z0`` the (B, N)
    batch and ``unravel`` maps (..., N) back to (..., *sample_shape);
    otherwise the inputs unchanged with ``unravel=None``.
    """
    check_state(z0)
    if z0.dim() < 1:
        raise ValueError("a batched state needs a leading batch dimension")
    if not use_pallas:
        return f, z0, None, False
    f_flat, _, unravel = flatten_problem(f, z0[0])
    return f_flat, z0.reshape(z0.shape[0], -1), unravel, True


def _rows(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B,) ``v`` shaped to broadcast over the rows of batch-leading
    ``like``."""
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


def _baxpy(h: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-row y + h_b * x over batch-leading tensors, h of shape (B,)."""
    return y + (_rows(h, x) * _promoted(h, x)).to(y.dtype)


def _rk_step_flat_batched(tab: Tableau, fb: Callable, t: torch.Tensor,
                          z: torch.Tensor, h: torch.Tensor,
                          k0: Optional[torch.Tensor],
                          err_scale: Optional[Tuple[Tol, Tol]]
                          ) -> StepResult:
    """Fused batched ψ over a (B, N) state: per-row stepsizes, per-row
    error norms. ``fb`` maps ((B,), (B, N)) -> (B, N)."""
    k0v = k0 if k0 is not None else fb(t, z)
    stages = [k0v]
    # one (s, B, N) buffer without autograd; under autograd (the ACA
    # replay) a stacked copy per kernel call, as in _rk_step_flat
    ks = None
    if not torch.is_grad_enabled():
        ks = torch.empty((tab.stages,) + tuple(z.shape), dtype=k0v.dtype,
                         device=z.device)
        ks[0] = k0v

    def rows(i):
        return ks[:i] if ks is not None else torch.stack(stages[:i])

    for i in range(1, tab.stages):
        zi = ops.rk_stage_increment_batched(z, rows(i), h, tab.a[i])
        ki = fb(t + tab.c[i] * h, zi)
        if ks is not None:
            ks[i] = ki
        stages.append(ki)

    ratio = None
    if tab.b_err is not None and err_scale is not None:
        rtol, atol = err_scale
        z_next, sq_sum = ops.rk_stage_combine_err_batched(
            z, rows(tab.stages), h, tab.b, tab.b_err, rtol, atol)
        ratio = torch.sqrt(sq_sum / torch.full_like(sq_sum, z.shape[-1]))
    else:
        z_next = ops.rk_stage_increment_batched(z, rows(tab.stages), h,
                                                tab.b)
    k_last = stages[-1] if tab.fsal else stages[0]
    return StepResult(z_next=z_next, err=None, k_last=k_last,
                      err_ratio=ratio)


def batched_field(f: VecField, args: Tuple) -> Callable:
    """The per-sample field ``f(t, z, *args)`` over the batch: (B,) times
    and batch-leading states, ``args`` shared by every row."""
    return vmap(lambda ti, zi: f(ti, zi, *args))


def rk_step_batched(tab: Tableau, f: VecField, t: torch.Tensor,
                    z: torch.Tensor, h: torch.Tensor, args: Tuple = (),
                    k0: Optional[torch.Tensor] = None, *,
                    use_pallas: bool = False,
                    err_scale: Optional[Tuple[Tol, Tol]] = None,
                    dense: bool = False) -> StepResult:
    """One explicit RK step per batch row: ψ_{h_b}(t_b, z_b) for all b.

    ``f`` is the per-sample field (no batch dimension); ``z`` carries a
    leading batch dimension B; ``t`` and ``h`` are (B,). With
    ``err_scale=(rtol, atol)`` the result's ``err_ratio`` is the (B,)
    vector of per-row scaled error norms (then ``err`` is None); the
    tolerances may be (B,) tensors, one per row, and a row at tolerance
    τ gives the bits of the all-τ scalar form. A row whose h_b is 0
    passes through unchanged: the masking the batched loop and the ACA
    replay use to freeze rows. ``use_pallas=True`` sends a (B, N)
    floating state to kernels K3 and K4/K5.
    """
    if dense:
        raise ValueError(
            "rk_step_batched(dense=True) (per-row interpolants) is not "
            "ported yet: it comes with slice D (ROADMAP queue 1)")
    fb = batched_field(f, args)
    if use_pallas and _is_flat_batched(z):
        return _rk_step_flat_batched(tab, fb, t, z, h, k0, err_scale)
    ks = []
    for i in range(tab.stages):
        if i == 0:
            ki = k0 if k0 is not None else fb(t, z)
        else:
            zi = _baxpy(h, _weighted_sum(ks, tab.a[i]), z)
            ki = fb(t + tab.c[i] * h, zi)
        ks.append(ki)

    z_next = _baxpy(h, _weighted_sum(ks, tab.b), z)
    err = ratio = None
    if tab.b_err is not None:
        e = _weighted_sum(ks, tab.b_err)
        err = _rows(h, e) * _promoted(h, e)
        if err_scale is not None:
            ratio = error_ratio_batched(err, z, z_next, *err_scale)
            err = None
    k_last = ks[-1] if tab.fsal else ks[0]
    return StepResult(z_next=z_next, err=err, k_last=k_last,
                      err_ratio=ratio)


def error_ratio_batched(err: torch.Tensor, z0: torch.Tensor,
                        z1: torch.Tensor, rtol: Tol,
                        atol: Tol) -> torch.Tensor:
    """``error_ratio`` of each row of batch-leading tensors: (B,) f32.
    ``rtol``/``atol`` are floats or (B,) tensors."""
    dims = (0, 0, 0, 0 if isinstance(rtol, torch.Tensor) else None,
            0 if isinstance(atol, torch.Tensor) else None)
    return vmap(error_ratio, in_dims=dims)(err, z0, z1, rtol, atol)
