"""SGD with (Nesterov) momentum — the optimizer of the paper's image
classification experiments (Sec. 4.2).

Port of ``repro/optim/sgd.py``, the same functional interface as
``adamw``: velocities in f32 whatever the parameter dtype, the schedule
read at the 1-based step, decoupled from autograd; on DTensor parameters
the velocities take their placements.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.distributed.regions import tree_context

from .adamw import Optimizer, Schedule, _sched_value

PyTree = Any


class SGDState(NamedTuple):
    step: torch.Tensor        # 0-d int32, the steps taken
    velocity: PyTree


def sgd(lr: Schedule, momentum: float = 0.9, nesterov: bool = False,
        weight_decay: float = 0.0) -> Optimizer:
    @torch.no_grad()
    def init(params):
        dev = pytree.tree_leaves(params)[0].device
        return SGDState(
            step=torch.zeros((), dtype=torch.int32, device=dev),
            velocity=pytree.tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params))

    @torch.no_grad()
    def update(grads, state: SGDState, params):
        with tree_context(params):
            return _update(grads, state, params)

    def _update(grads, state: SGDState, params):
        step = state.step + 1
        lr_t = _sched_value(lr, step)

        def upd(g, v, p):
            gf = g.float()
            if weight_decay:
                gf = gf + weight_decay * p.float()
            v2 = momentum * v + gf
            d = gf + momentum * v2 if nesterov else v2
            return (-lr_t * d).to(p.dtype), v2

        g_leaves, spec = pytree.tree_flatten(grads)
        pairs = [upd(g, v, p) for g, v, p in zip(
            g_leaves, pytree.tree_leaves(state.velocity),
            pytree.tree_leaves(params))]
        updates = pytree.tree_unflatten([x[0] for x in pairs], spec)
        vel = pytree.tree_unflatten([x[1] for x in pairs], spec)
        return updates, SGDState(step=step, velocity=vel)

    return Optimizer(init=init, update=update)
