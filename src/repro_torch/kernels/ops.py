"""Entry points of the port's kernels.

Differentiable dispatch over the RK stage kernels.

The counterpart of ``repro/kernels/ops.py``'s ``rk_stage_increment``,
``rk_stage_combine_err``, their batched forms (K3, and K4 or K5 by the
tolerances' rank) and ``rk_stage_combine`` (K6): each is a
``torch.autograd.Function`` whose forward launches the kernel (CUDA
tensor) or runs its plain version (CPU tensor), and whose backward
recomputes the plain version under ``enable_grad`` and returns its
vector-Jacobian product — as the JAX package's custom_vjp backward takes
``jax.vjp`` of the jnp twin. The tableau weights and tolerances, scalar or
per row, get no gradient.

The serving kernels K7 (``rmsnorm``), K8 (``flash_attention``), K9
(``ssd_scan``) and K10 (``rg_lru``) keep the reference's ``ops``
signatures minus the TPU tile arguments (K9 adds ``h0`` and returns the
final state). They are forward-only, as the reference's are (no
custom_vjp).
``launch_counts``/``reset_launches`` read and zero every kernel's counter.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from . import flash_attention as _flash_attention
from . import rg_lru as _rg_lru
from . import rk_stage
from . import rmsnorm as _rmsnorm
from . import ssd_scan as _ssd_scan

_COUNTED = (rk_stage, _rmsnorm, _flash_attention, _rg_lru, _ssd_scan)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last ``reset_launches``."""
    out: Dict[str, int] = {}
    for mod in _COUNTED:
        out.update(mod.launches)
    return out


def reset_launches() -> None:
    for mod in _COUNTED:
        mod.reset_launches()


def _vjp(fn: Callable, inputs: Tuple[torch.Tensor, ...], needs, cots):
    """Gradients of ``fn(*inputs)`` against ``cots`` for the inputs whose
    ``needs`` flag is set (None for the others)."""
    with torch.enable_grad():
        xs = tuple(x.detach().requires_grad_(bool(nd))
                   for x, nd in zip(inputs, needs))
        outs = fn(*xs)
        pairs = [(o, c) for o, c in zip(outs, cots)
                 if o is not None and c is not None and o.requires_grad]
        wrt = [x for x in xs if x.requires_grad]
        if not pairs or not wrt:
            return tuple(None for _ in xs)
        grads = iter(torch.autograd.grad([o for o, _ in pairs],
                                         wrt, [c for _, c in pairs],
                                         allow_unused=True))
    return tuple(next(grads) if x.requires_grad else None for x in xs)


class _Increment(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, k, h, a):
        ctx.a = a
        ctx.save_for_backward(z, k, h)
        return rk_stage.rk_stage_increment(z, k, h, a)

    @staticmethod
    def backward(ctx, g):
        z, k, h = ctx.saved_tensors
        grads = _vjp(
            lambda z_, k_, h_: (rk_stage.increment_plain(z_, k_, h_, ctx.a),),
            (z, k, h), ctx.needs_input_grad[:3], (g,))
        return (*grads, None)


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, k, h, b, e):
        ctx.consts = (b, e)
        ctx.save_for_backward(z, k, h)
        return rk_stage.rk_stage_combine(z, k, h, b, e)

    @staticmethod
    def backward(ctx, g_zn, g_err):
        z, k, h = ctx.saved_tensors
        b, e = ctx.consts
        grads = _vjp(
            lambda z_, k_, h_: rk_stage.combine_plain(z_, k_, h_, b, e),
            (z, k, h), ctx.needs_input_grad[:3], (g_zn, g_err))
        return (*grads, None, None)


class _CombineErr(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, k, h, b, e, rtol, atol, with_err):
        ctx.consts = (b, e, rtol, atol, with_err)
        ctx.save_for_backward(z, k, h)
        zn, err, partials = rk_stage.rk_stage_combine_err(
            z, k, h, b, e, rtol, atol, with_err=with_err)
        sq = partials.sum()
        return (zn, err, sq) if with_err else (zn, sq)

    @staticmethod
    def backward(ctx, *gs):
        z, k, h = ctx.saved_tensors
        b, e, rtol, atol, with_err = ctx.consts

        def plain(z_, k_, h_):
            zn, err, sq = rk_stage.combine_err_plain(
                z_, k_, h_, b, e, rtol, atol, with_err)
            sq = sq.reshape(())
            return (zn, err, sq) if with_err else (zn, sq)

        grads = _vjp(plain, (z, k, h), ctx.needs_input_grad[:3], gs)
        return (*grads, None, None, None, None, None)


def rk_stage_increment(z: torch.Tensor, k: torch.Tensor, h: torch.Tensor,
                       a: Sequence[float]) -> torch.Tensor:
    """Stage argument z + h * sum_j a_j k_j (K1); differentiable."""
    return _Increment.apply(z, k, h, tuple(float(w) for w in a))


def rk_stage_combine(z: torch.Tensor, k: torch.Tensor, h: torch.Tensor,
                     b: Sequence[float], e: Optional[Sequence[float]] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused (z + h * sum_i b_i k_i, h * sum_i e_i k_i) (K6);
    differentiable."""
    return _Combine.apply(z, k, h, tuple(float(w) for w in b),
                          tuple(float(w) for w in e) if e is not None
                          else None)


def rk_stage_combine_err(z: torch.Tensor, k: torch.Tensor, h: torch.Tensor,
                         b: Sequence[float], e: Sequence[float], rtol: float,
                         atol: float, *, with_err: bool = True
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                    torch.Tensor]:
    """Combine + scalar sum of squared scaled errors (K2); differentiable.

    Returns (z_next, err, sq_sum); sqrt(sq_sum / N) is ``error_ratio``.
    ``with_err=False`` skips the (N,) err store and returns None in the
    err slot.
    """
    out = _CombineErr.apply(z, k, h, tuple(float(w) for w in b),
                            tuple(float(w) for w in e), float(rtol),
                            float(atol), bool(with_err))
    if with_err:
        return out
    zn, sq = out
    return zn, None, sq


class _IncrementBatched(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, k, h, a):
        ctx.a = a
        ctx.save_for_backward(z, k, h)
        return rk_stage.rk_stage_increment_batched(z, k, h, a)

    @staticmethod
    def backward(ctx, g):
        z, k, h = ctx.saved_tensors
        grads = _vjp(
            lambda z_, k_, h_: (
                rk_stage.increment_batched_plain(z_, k_, h_, ctx.a),),
            (z, k, h), ctx.needs_input_grad[:3], (g,))
        return (*grads, None)


class _CombineErrBatched(torch.autograd.Function):
    """K4 (float tolerances) or K5 ((B,) tolerance tensors)."""

    @staticmethod
    def forward(ctx, z, k, h, rtol, atol, b, e):
        ctx.consts = (b, e)
        row_tol = isinstance(rtol, torch.Tensor)
        if row_tol:
            ctx.save_for_backward(z, k, h, rtol, atol)
            zn, partials = rk_stage.rk_stage_combine_err_batched_rowtol(
                z, k, h, b, e, rtol, atol)
        else:
            ctx.tols = (rtol, atol)
            ctx.save_for_backward(z, k, h)
            zn, partials = rk_stage.rk_stage_combine_err_batched(
                z, k, h, b, e, rtol, atol)
        return zn, partials.sum(dim=-1)

    @staticmethod
    def backward(ctx, g_zn, g_sq):
        saved = ctx.saved_tensors
        z, k, h = saved[:3]
        rtol, atol = saved[3:] if len(saved) == 5 else ctx.tols
        b, e = ctx.consts
        grads = _vjp(
            lambda z_, k_, h_: rk_stage.combine_err_batched_plain(
                z_, k_, h_, b, e, rtol, atol),
            (z, k, h), ctx.needs_input_grad[:3], (g_zn, g_sq))
        return (*grads, None, None, None, None)


def rk_stage_increment_batched(z: torch.Tensor, k: torch.Tensor,
                               h: torch.Tensor,
                               a: Sequence[float]) -> torch.Tensor:
    """Per-row stage argument z_b + h_b * sum_j a_j k_{j,b} over a (B, N)
    batch (K3); differentiable. Rows with h_b = 0 pass through."""
    return _IncrementBatched.apply(z, k, h, tuple(float(w) for w in a))


def rk_stage_combine_err_batched(
        z: torch.Tensor, k: torch.Tensor, h: torch.Tensor,
        b: Sequence[float], e: Sequence[float],
        rtol: Union[float, torch.Tensor], atol: Union[float, torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row combine + per-row sum of squared scaled errors over a (B, N)
    batch; differentiable.

    Returns (z_next (B, N), sq_sum (B,)); sqrt(sq_sum / N) is each row's
    ``error_ratio``. Float tolerances go to K4 (baked into the launch);
    if either is a tensor, both broadcast to (B,) f32 rows and go to K5.
    """
    bw = tuple(float(w) for w in b)
    ew = tuple(float(w) for w in e)
    if isinstance(rtol, torch.Tensor) or isinstance(atol, torch.Tensor):
        rows = (z.shape[0],)
        rt = torch.as_tensor(rtol, dtype=torch.float32,
                             device=z.device).broadcast_to(rows).contiguous()
        at = torch.as_tensor(atol, dtype=torch.float32,
                             device=z.device).broadcast_to(rows).contiguous()
        return _CombineErrBatched.apply(z, k, h, rt, at, bw, ew)
    return _CombineErrBatched.apply(z, k, h, float(rtol), float(atol), bw,
                                    ew)


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis, f32 statistics, out in x's dtype (K7)."""
    return _rmsnorm.rmsnorm(x, w, eps)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0, scale: Optional[float] = None
                    ) -> torch.Tensor:
    """Causal or sliding-window GQA attention, q (B, H, S, dh), k/v (B,
    Hkv, S, dh) (K8)."""
    return _flash_attention.flash_attention(q, k, v, window=window,
                                            scale=scale)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b_mat: torch.Tensor, c_mat: torch.Tensor, chunk: int,
             h0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD chunk scan (K9): (y (B, S, H, P) in x's dtype, h_last
    (B, H, P, N) f32)."""
    return _ssd_scan.ssd_scan(x, dt, a, b_mat, c_mat, chunk, h0=h0)


def rg_lru(log_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = exp(log_a_t) h_{t-1} + b_t over (B, S, C) in f32 (K10)."""
    return _rg_lru.rg_lru(log_a, b)
