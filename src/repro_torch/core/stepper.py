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

``dense=True`` also returns the first stage and, for Dopri5's ``b_mid``
row, the step-midpoint solution (one more K1/K3 launch on the fused
path); ``interp_fit``/``interp_eval`` build and read each step's
interpolant (plain tensor arithmetic, as in the reference).

Pytree (nested) states — dicts, tuples, lists, NamedTuples of tensors of
one floating dtype — are raveled once per solve by ``maybe_flatten`` /
``maybe_flatten_batched`` on both paths, so the engines carry one
tensor; outputs unravel back to the caller's structure. The error norm
then sums over the raveled vector, where the reference's plain path sums
leaf by leaf: the same norm in another order. Mixed-dtype pytrees (the
reference's per-leaf path) raise ``ValueError``.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import torch
from torch.func import vmap
from torch.utils import _pytree as pytree

from ..kernels import ops
from .controller import sqrt0
from .tableaus import Tableau

VecField = Callable[..., torch.Tensor]  # f(t, z, *args) -> dz/dt
Tol = Union[float, torch.Tensor]        # scalar, or (B,) under batching


def state_leaves(z0: Any):
    """``(leaves, spec)`` of a state: one floating tensor, or a pytree of
    tensors sharing one floating dtype."""
    leaves, spec = pytree.tree_flatten(z0)
    if not leaves or not all(isinstance(x, torch.Tensor) for x in leaves):
        raise ValueError(
            "the state must be a torch.Tensor or a pytree (dict, tuple, "
            f"list, NamedTuple) of tensors; got {type(z0).__name__}")
    dtypes = {x.dtype for x in leaves}
    if len(dtypes) > 1:
        names = sorted(str(d) for d in dtypes)
        raise ValueError(
            f"a pytree state whose leaves mix dtypes ({names}) is not "
            "ported yet: the per-leaf stepper path comes with slice J "
            "(ROADMAP queue 1); cast the leaves to one floating dtype")
    if not leaves[0].is_floating_point():
        raise ValueError(f"the state must be floating; got {leaves[0].dtype}")
    return leaves, spec


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
    # dense-output extras (``dense=True`` only): the first-stage
    # derivative the step consumed and, for tableaus with ``b_mid``, the
    # step-midpoint solution z + h·Σ b_mid_i k_i; they feed ``interp_fit``
    k_first: Optional[torch.Tensor] = None
    z_mid: Optional[torch.Tensor] = None


def _is_flat(z: torch.Tensor) -> bool:
    return z.dim() == 1 and z.is_floating_point()


def _ravel(tree: Any, batch_dims: int = 0) -> torch.Tensor:
    """The leaves of ``tree`` concatenated along one last axis, keeping
    ``batch_dims`` leading axes."""
    leaves = pytree.tree_leaves(tree)
    if len(leaves) == 1:
        x = leaves[0]
        return x.reshape(tuple(x.shape[:batch_dims]) + (-1,))
    return torch.cat([x.reshape(tuple(x.shape[:batch_dims]) + (-1,))
                      for x in leaves], dim=-1)


def flatten_problem(f: VecField, z0: Any):
    """Per-solve flat-state adapter.

    Returns ``(f_flat, z0_flat, unravel)``: the vector field over the
    raveled (N,) state, the raveled initial state (one tensor of any
    shape, or a pytree of tensors of one floating dtype), and ``unravel``
    mapping a (..., N) tensor back to z0's structure with (...) leading
    every leaf.
    """
    leaves, spec = state_leaves(z0)
    shapes = [tuple(x.shape) for x in leaves]
    sizes = [x.numel() for x in leaves]

    def unravel(x):
        lead = tuple(x.shape[:-1])
        parts = [x] if len(sizes) == 1 else torch.split(x, sizes, dim=-1)
        return pytree.tree_unflatten(
            [p.reshape(lead + s) for p, s in zip(parts, shapes)], spec)

    def f_flat(t, zf, *args):
        return _ravel(f(t, unravel(zf), *args))

    return f_flat, _ravel(z0), unravel


def maybe_flatten(f: VecField, z0: Any, use_pallas: bool):
    """``(f, z0, unravel, use_pallas)``: the flat problem when the fused
    path is requested or the state is a pytree, else the one-tensor
    inputs unchanged with ``unravel=None``."""
    state_leaves(z0)
    if not use_pallas and isinstance(z0, torch.Tensor):
        return f, z0, None, False
    f_flat, z0_flat, unravel = flatten_problem(f, z0)
    return f_flat, z0_flat, unravel, use_pallas


def _rk_step_flat(tab: Tableau, f: VecField, t, z: torch.Tensor, h,
                  args: Tuple, k0: Optional[torch.Tensor],
                  err_scale: Optional[Tuple[float, float]],
                  dense: bool = False) -> StepResult:
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
        ratio = sqrt0(sq_sum / torch.full_like(sq_sum, z.numel()))
    else:
        # no consumer for err here (the ACA replay reads only z_next): the
        # solution combine is K1 with the b row, without the err store
        z_next = ops.rk_stage_increment(z, rows(tab.stages), h, tab.b)
        err = None
    k_last = stages[-1] if tab.fsal else stages[0]
    z_mid = None
    if dense and tab.b_mid is not None:
        # the midpoint combine is K1 with the b_mid row
        z_mid = ops.rk_stage_increment(z, rows(tab.stages), h, tab.b_mid)
    return StepResult(z_next=z_next, err=err, k_last=k_last, err_ratio=ratio,
                      k_first=k0v if dense else None, z_mid=z_mid)


def rk_step(tab: Tableau, f: VecField, t, z: torch.Tensor, h,
            args: Tuple = (), k0: Optional[torch.Tensor] = None, *,
            use_pallas: bool = False,
            err_scale: Optional[Tuple[float, float]] = None,
            dense: bool = False) -> StepResult:
    """One explicit RK step of ``tab`` from (t, z) with stepsize h.

    ``k0`` optionally supplies the first stage derivative (FSAL). Returns
    z_{n+1}, the embedded error estimate h·Σ b_err_i k_i and the final
    stage derivative for FSAL chaining. ``use_pallas=True`` dispatches a
    1-D floating state to the fused kernels; there, with ``err_scale=(rtol,
    atol)``, the result carries the scaled error norm in ``err_ratio``,
    and without it ``err`` is None even for embedded tableaus.

    ``dense=True`` also returns ``interp_fit``'s inputs: ``k_first`` and,
    for tableaus with ``b_mid``, ``z_mid`` (one more K1 launch on the
    fused path). z_next is bitwise the same with and without ``dense``.
    """
    if use_pallas and _is_flat(z):
        return _rk_step_flat(tab, f, t, z, h, args, k0, err_scale, dense)
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
    z_mid = None
    if dense and tab.b_mid is not None:
        z_mid = _axpy(h, _weighted_sum(ks, tab.b_mid), z)
    return StepResult(z_next=z_next, err=err, k_last=k_last,
                      k_first=ks[0] if dense else None, z_mid=z_mid)


def error_ratio(err: torch.Tensor, z0: torch.Tensor, z1: torch.Tensor,
                rtol: float, atol: float) -> torch.Tensor:
    """RMS norm of err scaled by atol + rtol*max(|z0|,|z1|) (Hairer I.4).

    Returns a 0-d f32 tensor; an accepted step has ratio <= 1.
    """
    scale = atol + rtol * torch.maximum(torch.abs(z0), torch.abs(z1))
    r = (err / scale).float()
    total = torch.sum(r * r)
    return sqrt0(total / torch.full_like(total, r.numel()))


# ------------------------------------------------------------ batched form

def _is_flat_batched(z: torch.Tensor) -> bool:
    return z.dim() == 2 and z.is_floating_point()


def maybe_flatten_batched(f: VecField, z0: Any, use_pallas: bool):
    """Batched twin of ``maybe_flatten``: every leaf of ``z0`` carries a
    leading batch dimension B and ``f`` is the *per-sample* field.

    Returns ``(f, z0, unravel, use_pallas)``: with the fused path or a
    pytree state, ``f`` is the per-sample field over the raveled (N,)
    state, ``z0`` the (B, N) batch and ``unravel`` maps (..., N) back to
    the sample structure with (...) leading every leaf; otherwise the
    one-tensor inputs unchanged with ``unravel=None``.
    """
    leaves, _ = state_leaves(z0)
    if any(x.dim() < 1 for x in leaves):
        raise ValueError("a batched state needs a leading batch dimension")
    if not use_pallas and isinstance(z0, torch.Tensor):
        return f, z0, None, False
    f_flat, _, unravel = flatten_problem(
        f, pytree.tree_map(lambda x: x[0], z0))
    return f_flat, _ravel(z0, batch_dims=1), unravel, use_pallas


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
                          err_scale: Optional[Tuple[Tol, Tol]],
                          dense: bool = False) -> StepResult:
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
        ratio = sqrt0(sq_sum / torch.full_like(sq_sum, z.shape[-1]))
    else:
        z_next = ops.rk_stage_increment_batched(z, rows(tab.stages), h,
                                                tab.b)
    k_last = stages[-1] if tab.fsal else stages[0]
    z_mid = None
    if dense and tab.b_mid is not None:
        # each row's midpoint: K3 with the b_mid row
        z_mid = ops.rk_stage_increment_batched(z, rows(tab.stages), h,
                                               tab.b_mid)
    return StepResult(z_next=z_next, err=None, k_last=k_last,
                      err_ratio=ratio, k_first=k0v if dense else None,
                      z_mid=z_mid)


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
    floating state to kernels K3 and K4/K5. ``dense=True`` as in
    ``rk_step`` (per-row ``k_first`` and ``z_mid``).
    """
    fb = batched_field(f, args)
    if use_pallas and _is_flat_batched(z):
        return _rk_step_flat_batched(tab, fb, t, z, h, k0, err_scale,
                                     dense)
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
    z_mid = None
    if dense and tab.b_mid is not None:
        z_mid = _baxpy(h, _weighted_sum(ks, tab.b_mid), z)
    return StepResult(z_next=z_next, err=err, k_last=k_last,
                      err_ratio=ratio, k_first=ks[0] if dense else None,
                      z_mid=z_mid)


def error_ratio_batched(err: torch.Tensor, z0: torch.Tensor,
                        z1: torch.Tensor, rtol: Tol,
                        atol: Tol) -> torch.Tensor:
    """``error_ratio`` of each row of batch-leading tensors: (B,) f32.
    ``rtol``/``atol`` are floats or (B,) tensors."""
    dims = (0, 0, 0, 0 if isinstance(rtol, torch.Tensor) else None,
            0 if isinstance(atol, torch.Tensor) else None)
    return vmap(error_ratio, in_dims=dims)(err, z0, z1, rtol, atol)


# ------------------------------------------------------------ dense output
#
# Every accepted step carries enough for a local polynomial z(t + θh) ≈
# P(θ), θ in [0, 1], from quantities the loop already computed: the cubic
# Hermite through z0, z1 and the endpoint derivatives k0 (the first stage)
# and k1 (the FSAL last stage, or the post-accept evaluation of a non-FSAL
# pair), and for tableaus with ``b_mid`` (Dopri5) the quartic that also
# matches the midpoint solution. Both are one coefficient 5-tuple,
# P(θ) = (((c4 θ + c3) θ + c2) θ + c1) θ + c0, with c0 = z0 (P(0) is z0
# bitwise). Plain tensor arithmetic: the reference has no kernel here.


class InterpCoeffs(NamedTuple):
    """Coefficients of one step's interpolant, highest degree first:
    P(θ) = c4 θ⁴ + c3 θ³ + c2 θ² + c1 θ + c0."""
    c4: torch.Tensor
    c3: torch.Tensor
    c2: torch.Tensor
    c1: torch.Tensor
    c0: torch.Tensor


def _hb(h, leaf: torch.Tensor) -> torch.Tensor:
    """h (scalar or (B,)) in the state's dtype, shaped to broadcast over a
    state (batch-leading when h is (B,))."""
    h = torch.as_tensor(h, device=leaf.device).to(leaf.dtype)
    return h.reshape(tuple(h.shape) + (1,) * (leaf.dim() - h.dim()))


def interp_fit(z0: torch.Tensor, z1: torch.Tensor, k0: torch.Tensor,
               k1: torch.Tensor, h, z_mid: Optional[torch.Tensor] = None
               ) -> InterpCoeffs:
    """The step interpolant from endpoint (and midpoint) data; ``h`` is the
    accepted stepsize, a scalar or (B,) over batch-leading states. With
    ``z_mid`` the 4th-order quartic matching z0, z1, z_mid, k0 and k1;
    without it the cubic Hermite (c4 = 0). Differentiable throughout."""
    hk0 = (_hb(h, z0) * k0).to(z0.dtype)
    hk1 = (_hb(h, z0) * k1).to(z0.dtype)
    if z_mid is None:
        c4 = torch.zeros_like(z0)
        c3 = 2.0 * (z0 - z1) + hk0 + hk1
        c2 = 3.0 * (z1 - z0) - 2.0 * hk0 - hk1
    else:
        c4 = 2.0 * (hk1 - hk0) - 8.0 * (z0 + z1) + 16.0 * z_mid
        c3 = 5.0 * hk0 - 3.0 * hk1 + 18.0 * z0 + 14.0 * z1 - 32.0 * z_mid
        c2 = hk1 - 4.0 * hk0 - 11.0 * z0 - 5.0 * z1 + 16.0 * z_mid
    return InterpCoeffs(c4=c4, c3=c3, c2=c2, c1=hk0, c0=z0)


def _horner(c: InterpCoeffs, th: torch.Tensor) -> torch.Tensor:
    return (((c.c4 * th + c.c3) * th + c.c2) * th + c.c1) * th + c.c0


def interp_eval(coeffs: InterpCoeffs, theta: torch.Tensor) -> torch.Tensor:
    """P at ``theta``, theta's leading axis stacked onto the output: theta
    (T,) over a solo state (...) gives (T, ...); theta (T, B) over a
    batch-leading state (B, ...) gives (T, B, ...)."""
    c0 = coeffs.c0
    th = theta.to(c0.dtype).reshape(
        tuple(theta.shape) + (1,) * (c0.dim() - (theta.dim() - 1)))
    return _horner(coeffs, th)


def interp_eval_aligned(coeffs: InterpCoeffs,
                        theta: torch.Tensor) -> torch.Tensor:
    """P elementwise: theta's axes align with the coefficients' leading
    axes (theta (T,) over coefficients (T, ...) gives (T, ...))."""
    c0 = coeffs.c0
    th = theta.to(c0.dtype).reshape(
        tuple(theta.shape) + (1,) * (c0.dim() - theta.dim()))
    return _horner(coeffs, th)
