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

Pytree (nested) states — dicts, tuples, lists, NamedTuples of floating
tensors — are raveled once per solve by ``maybe_flatten`` /
``maybe_flatten_batched`` on both paths; outputs unravel back to the
caller's structure. Leaves of one dtype ravel into one tensor, which the
engines carry. Leaves of several dtypes ravel into *dtype groups*: one
flat tensor per dtype, in the order the dtypes first appear among the
leaves, and the engines carry the tuple of G groups. Every elementwise
operation maps over the groups (``gmap``), so each leaf computes in its
own dtype, as on the reference's per-leaf path; a mixed state never takes
the fused kernels (the reference's ``maybe_flatten`` rule). The error norm
sums over the raveled vector (over each group, then f32 partials over the
groups), where the reference's plain path sums leaf by leaf: the same
norm in another order.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import torch
from torch.func import vmap
from torch.utils import _pytree as pytree

from ..kernels import ops
from .controller import sqrt0
from .groups import gleaves, gmap
from .tableaus import Tableau

VecField = Callable[..., torch.Tensor]  # f(t, z, *args) -> dz/dt
Tol = Union[float, torch.Tensor]        # scalar, or (B,) under batching


def state_leaves(z0: Any):
    """``(leaves, spec)`` of a state: one floating tensor, or a pytree of
    floating tensors (their dtypes may differ)."""
    leaves, spec = pytree.tree_flatten(z0)
    if not leaves or not all(isinstance(x, torch.Tensor) for x in leaves):
        raise ValueError(
            "the state must be a torch.Tensor or a pytree (dict, tuple, "
            f"list, NamedTuple) of tensors; got {type(z0).__name__}")
    for x in leaves:
        if not x.is_floating_point():
            raise ValueError(
                f"the state must be floating; got a {x.dtype} leaf")
    return leaves, spec


def _promoted(h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x cast so that ``h * x`` computes in JAX's promoted dtype (a 0-d
    f32 stepsize times a bf16 tensor is f32 there, bf16 in torch)."""
    return x.to(torch.promote_types(h.dtype, x.dtype))


def _axpy(alpha: torch.Tensor, x, y):
    """y + alpha * x, rounded to y's dtype (an f32 stepsize must not
    upcast a bf16 state), group by group."""
    return gmap(lambda xl, yl: yl + (alpha * _promoted(alpha, xl)).to(
        yl.dtype), x, y)


# significant bits of the float dtypes below f64
_SIGNIFICAND = {torch.float32: 24, torch.float16: 11, torch.bfloat16: 8}


@functools.lru_cache(maxsize=None)
def _weight_in(w: float, dtype: torch.dtype) -> float:
    """The Python float ``w`` rounded to ``dtype``'s significand (half to
    even), as JAX rounds a weakly typed Python scalar to the dtype of the
    array it multiplies (normal range only, as a tableau weight is)."""
    bits = _SIGNIFICAND.get(dtype)
    if bits is None or w == 0.0:
        return w
    m, e = math.frexp(w)
    return math.ldexp(round(m * 2.0 ** bits), e - bits)


def _weighted_sum(ks, ws):
    """Σ_i ws[i] * ks[i], skipping exact-zero weights. Each weight is first
    rounded to its tensor's dtype (one tensor, or each dtype group), as
    the reference rounds a weakly typed weight to the leaf it multiplies:
    an f32 or f64 tensor keeps the bits of the unrounded weight, a bf16
    one multiplies by bf16(w)."""
    acc = None
    grouped = not isinstance(ks[0], torch.Tensor)
    for w, k in zip(ws, ks):
        if w == 0.0:
            continue
        if grouped:
            term = tuple(_weight_in(w, kl.dtype) * kl for kl in k)
        else:
            term = _weight_in(w, k.dtype) * k
        acc = term if acc is None else gmap(lambda a, b: a + b, acc, term)
    if acc is None:
        acc = gmap(torch.zeros_like, ks[0])
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


def _is_flat(z) -> bool:
    return (isinstance(z, torch.Tensor) and z.dim() == 1
            and z.is_floating_point())


def _ravel_leaves(leaves, batch_dims: int = 0) -> torch.Tensor:
    """``leaves`` concatenated along one last axis, keeping ``batch_dims``
    leading axes."""
    if len(leaves) == 1:
        x = leaves[0]
        return x.reshape(tuple(x.shape[:batch_dims]) + (-1,))
    return torch.cat([x.reshape(tuple(x.shape[:batch_dims]) + (-1,))
                      for x in leaves], dim=-1)


def _dtype_groups(leaves) -> list:
    """The leaf indices of each dtype, the dtypes in the order they first
    appear."""
    order = []
    for x in leaves:
        if x.dtype not in order:
            order.append(x.dtype)
    return [[i for i, x in enumerate(leaves) if x.dtype == d] for d in order]


def _flat_maps(z0: Any):
    """``(ravel, unravel)`` of a state's structure: ``ravel(tree,
    batch_dims)`` maps a tree of that structure (leaves with
    ``batch_dims`` more leading axes) to one (..., N) tensor, or to the
    tuple of its dtype groups (..., N_g); ``unravel`` maps either back,
    with (...) leading every leaf. Leaves are grouped by z0's dtypes, so
    a field's output leaf i joins the group of state leaf i."""
    leaves, spec = state_leaves(z0)
    shapes = [tuple(x.shape) for x in leaves]
    sizes = [x.numel() for x in leaves]
    groups = _dtype_groups(leaves)

    def ravel(tree, batch_dims: int = 0):
        ls = pytree.tree_leaves(tree)
        if len(groups) == 1:
            return _ravel_leaves(ls, batch_dims)
        return tuple(_ravel_leaves([ls[i] for i in idx], batch_dims)
                     for idx in groups)

    def split(x, idx):
        lead = tuple(x.shape[:-1])
        parts = [x] if len(idx) == 1 else torch.split(
            x, [sizes[i] for i in idx], dim=-1)
        return [p.reshape(lead + shapes[i]) for p, i in zip(parts, idx)]

    def unravel(x):
        if len(groups) == 1:
            return pytree.tree_unflatten(split(x, groups[0]), spec)
        out = [None] * len(leaves)
        for g, idx in zip(x, groups):
            for i, p in zip(idx, split(g, idx)):
                out[i] = p
        return pytree.tree_unflatten(out, spec)

    return ravel, unravel


def _flat_field(f: VecField, sample: Any):
    """``(f_flat, ravel, unravel)``: ``_flat_maps`` of ``sample`` and the
    field over its raveled form."""
    ravel, unravel = _flat_maps(sample)

    def f_flat(t, zf, *args):
        return ravel(f(t, unravel(zf), *args))

    return f_flat, ravel, unravel


def flatten_problem(f: VecField, z0: Any):
    """Per-solve flat-state adapter.

    Returns ``(f_flat, z0_flat, unravel)``: the vector field over the
    raveled (N,) state, the raveled initial state (one tensor of any
    shape, or a pytree of floating tensors), and ``unravel`` mapping a
    (..., N) tensor back to z0's structure with (...) leading every leaf.
    A pytree whose leaves mix dtypes ravels into the tuple of its dtype
    groups (see the module docstring), which ``f_flat`` takes and returns
    and ``unravel`` maps back.
    """
    f_flat, ravel, unravel = _flat_field(f, z0)
    return f_flat, ravel(z0), unravel


def maybe_flatten(f: VecField, z0: Any, use_pallas: bool):
    """``(f, z0, unravel, use_pallas)``: the flat problem when the fused
    path is requested or the state is a pytree, else the one-tensor
    inputs unchanged with ``unravel=None``. A mixed-dtype state comes
    back as its dtype groups with ``use_pallas`` False: it never takes the
    fused kernels, as in the reference."""
    state_leaves(z0)
    if not use_pallas and isinstance(z0, torch.Tensor):
        return f, z0, None, False
    f_flat, z0_flat, unravel = flatten_problem(f, z0)
    return (f_flat, z0_flat, unravel,
            use_pallas and isinstance(z0_flat, torch.Tensor))


def _rk_step_flat(tab: Tableau, f: VecField, t, z: torch.Tensor, h,
                  args: Tuple, k0: Optional[torch.Tensor],
                  err_scale: Optional[Tuple[float, float]],
                  dense: bool = False, group=None) -> StepResult:
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
        weighted = group is not None and group.weights is not None
        z_next, err, sq_sum = ops.rk_stage_combine_err(
            z, rows(tab.stages), h, tab.b, tab.b_err, rtol, atol,
            with_err=weighted)
        if weighted:
            # a weighted group's norm weighs each element: from the err
            ratio = error_ratio(err, z, z_next, rtol, atol, group)
            err = None
        elif group is not None:
            ratio = sqrt0(group.sum(sq_sum) / torch.full_like(
                sq_sum, group.numel(z.numel())))
        else:
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
            dense: bool = False, group=None) -> StepResult:
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
    ``group`` (a ``distributed.regions.SolveGroup``, the state split over
    ranks) makes the fused norm global.
    """
    if use_pallas and _is_flat(z):
        return _rk_step_flat(tab, f, t, z, h, args, k0, err_scale, dense,
                             group)
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
        err = gmap(lambda el: h * _promoted(h, el), e)
    k_last = ks[-1] if tab.fsal else ks[0]
    z_mid = None
    if dense and tab.b_mid is not None:
        z_mid = _axpy(h, _weighted_sum(ks, tab.b_mid), z)
    return StepResult(z_next=z_next, err=err, k_last=k_last,
                      k_first=ks[0] if dense else None, z_mid=z_mid)


def error_ratio(err, z0, z1, rtol: float, atol: float,
                group=None) -> torch.Tensor:
    """RMS norm of err scaled by atol + rtol*max(|z0|,|z1|) (Hairer I.4).

    Returns a 0-d f32 tensor; an accepted step has ratio <= 1. Over dtype
    groups each group's scaled error is formed in its dtype, cast to f32
    and squared, and the f32 sums add up over the groups. With ``group``
    (a ``SolveGroup``: the state split over ranks) the sum and the count
    are the whole state's.
    """
    total, n = None, 0
    for i, (e, a, b) in enumerate(zip(gleaves(err), gleaves(z0),
                                      gleaves(z1))):
        scale = atol + rtol * torch.maximum(torch.abs(a), torch.abs(b))
        r = (e / scale).float()
        part = torch.sum(r * r) if group is None else group.sum_sq(i, r)
        total = part if total is None else total + part
        n += r.numel()
    if group is not None:
        total, n = group.sum(total), group.numel(n)
    return sqrt0(total / torch.full_like(total, n))


# ------------------------------------------------------------ batched form

def _is_flat_batched(z) -> bool:
    return (isinstance(z, torch.Tensor) and z.dim() == 2
            and z.is_floating_point())


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
    f_flat, ravel, unravel = _flat_field(
        f, pytree.tree_map(lambda x: x[0], z0))
    z0_flat = ravel(z0, batch_dims=1)
    return (f_flat, z0_flat, unravel,
            use_pallas and isinstance(z0_flat, torch.Tensor))


def _rows(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(B,) ``v`` shaped to broadcast over the rows of batch-leading
    ``like``."""
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


def _baxpy(h: torch.Tensor, x, y):
    """Per-row y + h_b * x over batch-leading states, h of shape (B,)."""
    return gmap(lambda xl, yl: yl + (_rows(h, xl) * _promoted(h, xl)).to(
        yl.dtype), x, y)


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
        err = gmap(lambda el: _rows(h, el) * _promoted(h, el), e)
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


def error_ratio_batched(err, z0, z1, rtol: Tol, atol: Tol) -> torch.Tensor:
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


def interp_fit(z0, z1, k0, k1, h, z_mid=None) -> InterpCoeffs:
    """The step interpolant from endpoint (and midpoint) data; ``h`` is the
    accepted stepsize, a scalar or (B,) over batch-leading states. With
    ``z_mid`` the 4th-order quartic matching z0, z1, z_mid, k0 and k1;
    without it the cubic Hermite (c4 = 0). Differentiable throughout. Over
    dtype groups, each coefficient is the tuple of the groups' own."""
    if isinstance(z0, torch.Tensor):
        return _interp_fit(z0, z1, k0, k1, h, z_mid)
    mids = z_mid if z_mid is not None else (None,) * len(z0)
    parts = [_interp_fit(*g, h, m) for g, m in zip(zip(z0, z1, k0, k1),
                                                     mids)]
    return InterpCoeffs(*(tuple(p[j] for p in parts) for j in range(5)))


def _interp_fit(z0: torch.Tensor, z1: torch.Tensor, k0: torch.Tensor,
                k1: torch.Tensor, h, z_mid: Optional[torch.Tensor]
                ) -> InterpCoeffs:
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


def _groups_of(coeffs: InterpCoeffs) -> list:
    """A grouped interpolant as one ``InterpCoeffs`` per dtype group."""
    return [InterpCoeffs(*g) for g in zip(*coeffs)]


def interp_eval(coeffs: InterpCoeffs, theta: torch.Tensor):
    """P at ``theta``, theta's leading axis stacked onto the output: theta
    (T,) over a solo state (...) gives (T, ...); theta (T, B) over a
    batch-leading state (B, ...) gives (T, B, ...)."""
    c0 = coeffs.c0
    if not isinstance(c0, torch.Tensor):
        return tuple(interp_eval(c, theta) for c in _groups_of(coeffs))
    th = theta.to(c0.dtype).reshape(
        tuple(theta.shape) + (1,) * (c0.dim() - (theta.dim() - 1)))
    return _horner(coeffs, th)


def interp_eval_aligned(coeffs: InterpCoeffs, theta: torch.Tensor):
    """P elementwise: theta's axes align with the coefficients' leading
    axes (theta (T,) over coefficients (T, ...) gives (T, ...))."""
    c0 = coeffs.c0
    if not isinstance(c0, torch.Tensor):
        return tuple(interp_eval_aligned(c, theta)
                     for c in _groups_of(coeffs))
    th = theta.to(c0.dtype).reshape(
        tuple(theta.shape) + (1,) * (c0.dim() - theta.dim()))
    return _horner(coeffs, th)


# --------------------------------------------------------------------------
# Asynchronous-leapfrog (ALF): the reversible pair stepper of MALI
# --------------------------------------------------------------------------
#
# One ALF step advances the pair (z, v), v ≈ dz/dt (MALI, Zhuang et al.
# 2021):
#
#     u  = z + (h/2)·v        half-position drift
#     w  = f(t + h/2, u)      one field evaluation
#     v' = 2w − v             velocity reflection
#     z' = u + (h/2)·v'       half-position drift with the new velocity
#
# Algebraically the step inverts itself (u = z' − (h/2)·v' recovers the
# midpoint), but float addition loses bits, so the pair is carried on a
# fixed-point integer lattice: z and v are int32 (f32/bf16 leaves) or
# int64 (f64 leaves) multiples of a per-solve quantum δ = 2^(scale_exp −
# frac), and every drift and reflection is an integer add or subtract of
# an increment that both directions recompute from the same bits.
# Integer addition wraps, so it is a bijection: ``alf_step_inverse``
# recovers the previous pair bit for bit for any input, provided f gives
# the same bits forward and backward. The quanta are exact powers of two
# built from exponent bits (``_pow2``), and rounding is half to even, as
# in the reference. ``alf_step_float`` is the differentiable twin the
# backward sweep linearizes (the δ-rounding treated as the identity);
# with ``use_pallas`` its two half-drifts are kernel K1 (K3 batched) with
# the one-weight row (0.5,).

ALF_ORDER = 2  # ALF is second order; its embedded Euler comparator first

HALF_DRIFT = (0.5,)   # the K1/K3 weight row of one half-drift


def _lattice_frac(fdt: torch.dtype) -> int:
    """Fractional bits of the lattice of a float leaf dtype: the quantum
    is δ = 2^(scale_exp − frac)."""
    return 52 if fdt == torch.float64 else 24


def _lattice_int_dtype(fdt: torch.dtype) -> torch.dtype:
    return torch.int64 if fdt == torch.float64 else torch.int32


def _lattice_clip_bound(fdt: torch.dtype) -> float:
    """The largest coordinate a quantized leaf is clipped to: 2^62 for
    f64 leaves, 2^31 − 128 (the largest f32 below 2^31) otherwise."""
    return float(2 ** 62) if fdt == torch.float64 else float(2 ** 31 - 128)


def _pow2(e: torch.Tensor, fdt: torch.dtype) -> torch.Tensor:
    """2^e exactly, for an integer-valued f32 exponent tensor, in dtype
    ``fdt``: built from the exponent bits, so no device's exp2 rounding
    enters the quantum (normal range only, as every lattice needs)."""
    if fdt == torch.float64:
        return ((e.to(torch.int64) + 1023) << 52).view(torch.float64)
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32).to(fdt)


def _ceil_log2(x: torch.Tensor) -> torch.Tensor:
    """⌈log₂ x⌉ of f32 x >= 1 as f32, from ``frexp``'s exponent (exact on
    every device: x = m·2^e with m in [0.5, 1), a power of two at m =
    0.5)."""
    m, e = torch.frexp(x)
    return (e - (m == 0.5).to(e.dtype)).to(torch.float32)


def alf_lattice_exponent(z0: Any, v0: Any, group=None) -> torch.Tensor:
    """The per-solve lattice scale exponent ⌈log₂ max(|z0|, |v0|, 1)⌉: one
    0-d f32 tensor shared by every leaf (the quantum is δ_leaf =
    2^(scale_exp − frac(dtype))). The int32 lattice spans ±128× the
    initial scale at one f32 ulp of it; states far beyond wrap
    (deterministically; the error test rejects such steps first). With
    ``group`` the max is the whole split state's."""
    leaves = pytree.tree_leaves(z0) + pytree.tree_leaves(v0)
    mx = torch.ones((), dtype=torch.float32, device=leaves[0].device)
    for leaf in leaves:
        if leaf.numel():
            mx = torch.maximum(mx, torch.abs(leaf.float()).max())
    if group is not None:
        mx = group.max(mx)
    return _ceil_log2(mx)


def alf_lattice_exponent_batched(z0: Any, v0: Any) -> torch.Tensor:
    """Per-row lattice exponents (B,) over batch-leading leaves: each row
    quantizes as a solo solve of it would."""
    leaves = pytree.tree_leaves(z0) + pytree.tree_leaves(v0)
    B = leaves[0].shape[0]
    mx = torch.ones(B, dtype=torch.float32, device=leaves[0].device)
    for leaf in leaves:
        if leaf.numel():
            mx = torch.maximum(mx, torch.abs(leaf.float()).reshape(
                B, -1).amax(dim=1))
    return _ceil_log2(mx)


def _se_b(scale_exp: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A scale exponent, 0-d or (B,) over batch-leading leaves, shaped to
    broadcast against ``leaf``."""
    se = scale_exp.to(torch.float32)
    return se.reshape(tuple(se.shape) + (1,) * (leaf.dim() - se.dim()))


def _lattice_quantize_leaf(x: torch.Tensor,
                           scale_exp: torch.Tensor) -> torch.Tensor:
    """A float leaf rounded to its integer lattice coordinate: the one
    quantization rule both directions call. The product x·(1/δ) rounds in
    x's dtype (exact unless it leaves the dtype's range); a bf16 product
    at the clip bound (2^31 in bf16) saturates to 2^31 − 1."""
    fdt = x.dtype
    frac = torch.full((), _lattice_frac(fdt), dtype=torch.float32,
                      device=x.device)
    q = torch.round(x * _pow2(frac - _se_b(scale_exp, x), fdt))
    lim = _lattice_clip_bound(fdt)
    q = torch.clamp(q, -lim, lim)
    idt = _lattice_int_dtype(fdt)
    if fdt == torch.bfloat16:
        q = torch.clamp(q.double(), -2.0 ** 31, 2.0 ** 31 - 1)
    return q.to(idt)


def _lattice_decode_leaf(q: torch.Tensor, scale_exp: torch.Tensor,
                         fdt: torch.dtype) -> torch.Tensor:
    frac = torch.full((), _lattice_frac(fdt), dtype=torch.float32,
                      device=q.device)
    return q.to(fdt) * _pow2(_se_b(scale_exp, q) - frac, fdt)


def lattice_encode(x: Any, scale_exp: torch.Tensor) -> Any:
    """Float pytree -> integer-lattice pytree (int32 per f32/bf16 leaf,
    int64 per f64 leaf), quantum δ = 2^(scale_exp − frac)."""
    return pytree.tree_map(lambda l: _lattice_quantize_leaf(l, scale_exp),
                           x)


def lattice_decode(q: Any, scale_exp: torch.Tensor, proto: Any) -> Any:
    """Integer-lattice pytree -> float pytree in ``proto``'s leaf dtypes
    (the exact inverse scaling of ``lattice_encode``'s grid)."""
    return pytree.tree_map(
        lambda ql, pl: _lattice_decode_leaf(ql, scale_exp, pl.dtype), q,
        proto)


def lattice_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b on the lattice: two's-complement integer addition, which
    wraps at the integer dtype's range on the CPU and on CUDA
    (``tests/test_torch_mali.py`` and the card tests pin it)."""
    return a + b


def lattice_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a − b on the lattice, wrapping as ``lattice_add``."""
    return a - b


def _drift_increment(h, v_float: Any, scale_exp: torch.Tensor) -> Any:
    """The quantized half-drift Q((h/2)·v) per leaf, as lattice integers;
    ``h`` (0-d, or (B,) over batch-leading leaves) is cast to each
    leaf's dtype first, as in the reference."""
    def leaf(v):
        hh = _hb(h, v) * torch.full((), 0.5, dtype=v.dtype, device=v.device)
        return _lattice_quantize_leaf(hh * v, scale_exp)

    return pytree.tree_map(leaf, v_float)


def _tree_iadd(a: Any, b: Any) -> Any:
    return pytree.tree_map(lattice_add, a, b)


def _tree_isub(a: Any, b: Any) -> Any:
    return pytree.tree_map(lattice_sub, a, b)


def _alf_midpoint_t(t, h):
    """t + h/2, written once so forward and inverse compute the same
    bits."""
    return t + 0.5 * h


def _reflect(w: Any, vq: Any, scale_exp: torch.Tensor) -> Any:
    """The reflection on the lattice, Q(2w) − vq (2w is exact)."""
    return _tree_isub(pytree.tree_map(
        lambda wl: _lattice_quantize_leaf(2.0 * wl, scale_exp), w), vq)


class AlfResult(NamedTuple):
    """One ALF trial over the lattice pair: the advanced coordinates
    ``zq_next``/``vq_next`` (the carry), the decoded state ``z_next``
    (outputs, error scale) and the embedded error h·(w − v), the gap
    between the midpoint update z + h·w and the Euler predictor z + h·v."""
    zq_next: Any
    vq_next: Any
    z_next: Any
    err: Any


def _alf_forward(fw: Callable, t, h, zq, vq, scale_exp, proto) -> AlfResult:
    """``alf_step`` with the field already closed over its args (``fw(t,
    u)``: solo, or vmapped over the rows)."""
    vf = lattice_decode(vq, scale_exp, proto)
    uq = _tree_iadd(zq, _drift_increment(h, vf, scale_exp))
    w = fw(_alf_midpoint_t(t, h), lattice_decode(uq, scale_exp, proto))
    vq_next = _reflect(w, vq, scale_exp)
    vf_next = lattice_decode(vq_next, scale_exp, proto)
    zq_next = _tree_iadd(uq, _drift_increment(h, vf_next, scale_exp))
    err = pytree.tree_map(
        lambda wl, vl: _hb(h, vl) * (wl.to(vl.dtype) - vl), w, vf)
    return AlfResult(zq_next=zq_next, vq_next=vq_next,
                     z_next=lattice_decode(zq_next, scale_exp, proto),
                     err=err)


def _alf_inverse(fw: Callable, t, h, zq_next, vq_next, scale_exp, proto):
    """``alf_step_inverse`` with the field closed over its args."""
    vf_next = lattice_decode(vq_next, scale_exp, proto)
    uq = _tree_isub(zq_next, _drift_increment(h, vf_next, scale_exp))
    w = fw(_alf_midpoint_t(t, h), lattice_decode(uq, scale_exp, proto))
    vq = _reflect(w, vq_next, scale_exp)
    vf = lattice_decode(vq, scale_exp, proto)
    zq = _tree_isub(uq, _drift_increment(h, vf, scale_exp))
    return zq, vq


def alf_step(f: VecField, t, h, zq: Any, vq: Any, scale_exp: torch.Tensor,
             proto: Any, args: Tuple = ()) -> AlfResult:
    """One asynchronous-leapfrog step on the integer lattice.

    ``zq``/``vq`` are lattice pytrees (``lattice_encode``), ``proto`` a
    float pytree fixing the leaf dtypes, ``t``/``h`` 0-d tensors. Every
    state update is an integer add, so ``alf_step_inverse(alf_step(s))
    == s`` bit for bit for any state. One evaluation of f.
    """
    return _alf_forward(lambda tm, u: f(tm, u, *args), t, h, zq, vq,
                        scale_exp, proto)


def alf_step_inverse(f: VecField, t, h, zq_next: Any, vq_next: Any,
                     scale_exp: torch.Tensor, proto: Any,
                     args: Tuple = ()) -> Tuple[Any, Any]:
    """The exact inverse of ``alf_step``: each quantized increment is
    recomputed from the side the inverse already knows (v' for the second
    drift, the recovered v for the first) and subtracted: the pre-step
    pair, bit for bit."""
    return _alf_inverse(lambda tm, u: f(tm, u, *args), t, h, zq_next,
                        vq_next, scale_exp, proto)


def _half_drift_plain(h, v, z, batched: bool):
    """z + h·(v/2) on the plain path (``_axpy``, per row when batched)."""
    axpy = _baxpy if batched else _axpy
    return pytree.tree_map(lambda vl, zl: axpy(h, 0.5 * vl, zl), v, z)


def alf_step_float(f: VecField, t, h, z: Any, v: Any, args: Tuple = (), *,
                   use_pallas: bool = False) -> Tuple[Any, Any]:
    """The differentiable float twin of ``alf_step`` (δ-rounding taken as
    the identity): ``(z', v')``. The MALI backward sweep differentiates it
    at the reconstructed pair. With ``use_pallas`` and a flat (N,) state
    the two half-drifts are kernel K1 with the row (0.5,) (its plain
    version on a CPU tensor); the reflection stays one tensor axpy."""
    tm = _alf_midpoint_t(t, h)
    if use_pallas and isinstance(z, torch.Tensor) and _is_flat(z):
        u = ops.rk_stage_increment(z, v[None], h, HALF_DRIFT)
        v_next = 2.0 * f(tm, u, *args) - v
        return ops.rk_stage_increment(u, v_next[None], h, HALF_DRIFT), v_next
    u = _half_drift_plain(h, v, z, batched=False)
    w = f(tm, u, *args)
    v_next = pytree.tree_map(lambda wl, vl: 2.0 * wl - vl, w, v)
    return _half_drift_plain(h, v_next, u, batched=False), v_next


def alf_step_batched(f: VecField, t: torch.Tensor, h: torch.Tensor,
                     zq: Any, vq: Any, scale_exp: torch.Tensor, proto: Any,
                     args: Tuple = ()) -> AlfResult:
    """Per-row ALF trial over batch-leading lattice leaves: ``t``/``h``
    (B,), ``scale_exp`` (B,), the per-sample field vmapped over the rows.
    Callers keep a frozen row by masking its carry: the h = 0 ALF step is
    not the identity in v (the reflection still fires)."""
    return _alf_forward(batched_field(f, args), t, h, zq, vq, scale_exp,
                        proto)


def alf_step_inverse_batched(f: VecField, t: torch.Tensor, h: torch.Tensor,
                             zq_next: Any, vq_next: Any,
                             scale_exp: torch.Tensor, proto: Any,
                             args: Tuple = ()) -> Tuple[Any, Any]:
    """The batched twin of ``alf_step_inverse`` (per-row t, h and
    lattice). Evaluate it on every row, as the forward did, so each row's
    field rounds as it did forward."""
    return _alf_inverse(batched_field(f, args), t, h, zq_next, vq_next,
                        scale_exp, proto)


def alf_step_float_batched(f: VecField, t: torch.Tensor, h: torch.Tensor,
                           z: Any, v: Any, args: Tuple = (), *,
                           use_pallas: bool = False) -> Tuple[Any, Any]:
    """The batched differentiable twin (per-row t, h); with ``use_pallas``
    and a (B, N) state the half-drifts are kernel K3 with the row
    (0.5,)."""
    fb = batched_field(f, args)
    tm = _alf_midpoint_t(t, h)
    if use_pallas and isinstance(z, torch.Tensor) and _is_flat_batched(z):
        u = ops.rk_stage_increment_batched(z, v[None], h, HALF_DRIFT)
        v_next = 2.0 * fb(tm, u) - v
        return (ops.rk_stage_increment_batched(u, v_next[None], h,
                                               HALF_DRIFT), v_next)
    u = _half_drift_plain(h, v, z, batched=True)
    w = fb(tm, u)
    v_next = pytree.tree_map(lambda wl, vl: 2.0 * wl - vl, w, v)
    return _half_drift_plain(h, v_next, u, batched=True), v_next
