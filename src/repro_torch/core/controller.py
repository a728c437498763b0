"""PI stepsize controller for the adaptive embedded RK solvers.

Port of ``repro/core/controller.py``. The next stepsize is

    h_next = h * clip(safety * ratio^{-1/p} * prev_ratio^{k_P}, dfac, ifac)

with ratio the scaled error norm of the current trial (Hairer & Wanner,
"Solving ODEs II", IV.2); the initial stepsize is Hairer I.4's ``hinit``.
All arithmetic stays in torch tensors of the time dtype on the state's
device: Python floats are f64 and would move the accepted grid away from
the reference's, and host scalars would cost a copy per trial.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from .groups import gleaves, gmap


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """PI stepsize-controller settings + the solve's step/trial budgets.

    ``max_steps`` bounds *accepted* steps (= checkpoint-buffer capacity,
    the paper's N_t); ``max_trials`` bounds the inner stepsize search per
    step (the paper's m), so one solve performs at most ``max_steps *
    max_trials`` trials.
    """
    safety: float = 0.9
    min_factor: float = 0.2     # max shrink per retry
    max_factor: float = 10.0    # max growth after accept
    pi_coeff: float = 0.04      # k_P (integral-of-log smoothing); 0 = plain P
    max_steps: int = 256        # checkpoint-buffer capacity (paper's N_t bound)
    max_trials: int = 12        # bound on the paper's m (inner search)


def _div(num: float, den: torch.Tensor) -> torch.Tensor:
    """num / den as one IEEE division in den's dtype (``float / tensor``
    in torch is a reciprocal and a multiply, two roundings)."""
    return torch.full_like(den, num) / den


def propose_stepsize(cfg: ControllerConfig, h: torch.Tensor,
                     ratio: torch.Tensor, prev_ratio: torch.Tensor,
                     order: int) -> torch.Tensor:
    """Next stepsize after a trial with scaled error ``ratio``; used for
    shrink-on-reject and grow-on-accept alike (the PI term reads the
    previous accepted step's ratio)."""
    k_i = 1.0 / float(order)
    k_p = cfg.pi_coeff
    # guard against ratio == 0 (exact solution) -> max growth
    ratio = torch.clamp(ratio, min=1e-10)
    prev_ratio = torch.clamp(prev_ratio, min=1e-10)
    factor = cfg.safety * ratio ** (-k_i) * prev_ratio ** k_p
    factor = torch.clamp(factor, cfg.min_factor, cfg.max_factor)
    return h * factor


def sqrt0(x: torch.Tensor) -> torch.Tensor:
    """``torch.sqrt`` with the same values and a zero gradient at 0.

    The naive method differentiates the error norm and the initial
    stepsize: at an exact zero (a field or an error estimate that
    vanishes) sqrt's infinite slope meets a zero cotangent and gives NaN,
    which the reference's naive gradient returns there. NaN and Inf
    inputs keep their values, so failure detection still reads them."""
    zero = x == 0
    return torch.where(zero, torch.zeros_like(x),
                       torch.sqrt(torch.where(zero, torch.ones_like(x), x)))


def _rms(x, group=None) -> torch.Tensor:
    """The RMS of a state (one tensor, or its dtype groups), each group's
    squares summed in f32 and the sums added up over the groups; over
    the whole split state with ``group`` (a ``SolveGroup``)."""
    total, n = None, 0
    for i, g in enumerate(gleaves(x)):
        xf = g.float()
        part = torch.sum(xf * xf) if group is None else group.sum_sq(i, xf)
        total = part if total is None else total + part
        n += g.numel()
    if group is not None:
        total, n = group.sum(total), group.numel(n)
    return sqrt0(total / torch.full((), n, dtype=torch.float32,
                                    device=total.device))


def initial_stepsize(f: Callable, t0: torch.Tensor, z0,
                     args: Tuple, order: int, rtol: float,
                     atol: float, group=None) -> torch.Tensor:
    """Hairer I.4 'starting step size' heuristic (two evaluations of f).

    No Python branch reads a tensor value, so the batched solve and the
    serving engine ``torch.func.vmap`` it over rows and per-row
    tolerances (``rtol``/``atol`` then arrive as 0-d tensors). Over dtype
    groups the norms run over every group, as the reference's over every
    leaf. With ``group`` the norms are the whole split state's."""
    scale = gmap(lambda z: atol + rtol * torch.abs(z), z0)
    f0 = f(t0, z0, *args)
    d0 = _rms(gmap(torch.div, z0, scale), group)
    d1 = _rms(gmap(torch.div, f0, scale), group)
    # each unselected branch divides by a value kept away from 0, so its
    # gradient cannot turn into NaN (the naive method differentiates h0)
    small = (d0 < 1e-5) | (d1 < 1e-5)
    h0 = torch.where(small, torch.full_like(d0, 1e-6),
                     0.01 * d0 / torch.where(small, torch.ones_like(d1), d1))
    # as in JAX, the f32 h0 promotes a lower-precision state here
    def euler(z, g):
        pt = torch.promote_types(h0.dtype, z.dtype)
        return z.to(pt) + h0 * g.to(pt)

    z1 = gmap(euler, z0, f0)
    f1 = f(t0 + h0, z1, *args)
    d2 = _rms(gmap(lambda a, b, s: (a - b) / s, f1, f0, scale),
              group) / h0
    dmax = torch.maximum(d1, d2)
    # Hairer I.4 step (f): h1 = (0.01 / max(d1, d2))^(1/(p+1))
    flat = dmax <= 1e-15
    h1 = torch.where(
        flat,
        torch.clamp(h0 * 1e-3, min=1e-6),
        _div(0.01, torch.where(flat, torch.ones_like(dmax), dmax))
        ** (1.0 / (float(order) + 1.0)),
    )
    return torch.minimum(100.0 * h0, h1)
