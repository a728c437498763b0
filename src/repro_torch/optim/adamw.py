"""AdamW with decoupled weight decay (Loshchilov & Hutter).

Port of ``repro/optim/adamw.py``, the same functional interface over
pytrees of tensors::

    opt = adamw(lr_schedule, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

and the reference's arithmetic in its order: b2 defaults to 0.95, the
schedule is read at the 1-based step, eps is added after sqrt(n / c2),
moments are f32 whatever the parameter dtype, and the decoupled decay
applies to the leaves with ndim >= 2 (or those ``mask(params)`` selects).
``torch.optim.AdamW`` is another optimizer (b2 0.999, decay on every
leaf). Everything runs without autograd. On DTensor parameters (a mesh)
the moments are DTensors with the parameters' placements, each rank
updating its own block (ZeRO: the optimizer state is sharded as the
parameters are).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import torch
from torch.utils import _pytree as pytree

from repro_torch.distributed.regions import tree_context

PyTree = Any
Schedule = Union[float, Callable[[torch.Tensor], torch.Tensor]]


class AdamWState(NamedTuple):
    step: torch.Tensor        # 0-d int32, the steps taken
    mu: PyTree
    nu: PyTree


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], Any]
    update: Callable[..., Tuple[PyTree, Any]]


def _sched_value(s: Schedule, step: torch.Tensor) -> torch.Tensor:
    if callable(s):
        return s(step)
    return torch.full((), s, dtype=torch.float32, device=step.device)


def adamw(lr: Schedule, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          mask: Optional[Callable[[PyTree], PyTree]] = None) -> Optimizer:
    """``mask(params)`` -> bool tree selects which leaves get decay
    (default: every leaf with ndim >= 2 — biases/norms are excluded)."""

    def default_mask(params):
        return pytree.tree_map(lambda p: p.dim() >= 2, params)

    decay_mask = mask or default_mask

    @torch.no_grad()
    def init(params):
        def zeros(p):   # a DTensor's moments take its placements
            return torch.zeros_like(p, dtype=torch.float32)

        dev = pytree.tree_leaves(params)[0].device
        return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                          mu=pytree.tree_map(zeros, params),
                          nu=pytree.tree_map(zeros, params))

    @torch.no_grad()
    def update(grads, state: AdamWState, params):
        with tree_context(params):
            return _update(grads, state, params)

    def _update(grads, state: AdamWState, params):
        step = state.step + 1
        lr_t = _sched_value(lr, step)
        c1 = 1.0 - b1 ** step.float()
        c2 = 1.0 - b2 ** step.float()

        def moments(g, m, n):
            gf = g.float()
            return b1 * m + (1 - b1) * gf, b2 * n + (1 - b2) * gf * gf

        g_leaves, spec = pytree.tree_flatten(grads)
        mn = [moments(g, m, n) for g, m, n in zip(
            g_leaves, pytree.tree_leaves(state.mu),
            pytree.tree_leaves(state.nu))]
        mu = pytree.tree_unflatten([x[0] for x in mn], spec)
        nu = pytree.tree_unflatten([x[1] for x in mn], spec)

        def step_fn(m, n, p, use_wd):
            u = -(lr_t * ((m / c1) / (torch.sqrt(n / c2) + eps)))
            if weight_decay:
                u = u - lr_t * weight_decay * torch.where(
                    torch.as_tensor(use_wd, device=p.device), p.float(),
                    torch.zeros((), dtype=torch.float32, device=p.device))
            return u.to(p.dtype)

        updates = pytree.tree_map(step_fn, mu, nu, params,
                                  decay_mask(params))
        return updates, AdamWState(step=step, mu=mu, nu=nu)

    return Optimizer(init=init, update=update)


@torch.no_grad()
def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    """p + u for every leaf, as new tensors that keep each parameter's
    ``requires_grad``."""
    return pytree.tree_map(
        lambda p, u: (p + u).requires_grad_(p.requires_grad), params,
        updates)
