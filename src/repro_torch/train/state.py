"""TrainState: params + optimizer state + step, with its sharding specs.

Port of ``repro/train/state.py``: ``TrainState``, ``make_train_state``,
``abstract_train_state`` (shape and dtype stand-ins: tensors on the
``meta`` device, so the full-size configs allocate nothing) and
``train_state_specs`` (the partition specs of every leaf on a mesh: the
optimizer moments follow the parameters' specs, scalars are replicated).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import P
from repro_torch.models.lm import Model
from repro_torch.optim.adamw import Optimizer

PyTree = Any


class TrainState(NamedTuple):
    step: torch.Tensor        # 0-d int32
    params: PyTree
    opt_state: Any


def make_train_state(model: Model, opt: Optimizer, seed: int = 0,
                     device="cuda") -> TrainState:
    """Fresh parameters (``model.init(seed, device)``) and optimizer
    state, step 0, on ``device`` (the card unless the caller asks for the
    CPU). On ``model.rcfg.mesh`` the parameters are DTensors and the
    moments, made from them, carry their placements."""
    dev = resolve_device(device)
    params = model.init(seed=seed, device=dev)
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      params=params, opt_state=opt.init(params))


def abstract_train_state(model: Model, opt: Optimizer) -> TrainState:
    """The TrainState's shapes and dtypes as meta tensors: no memory is
    allocated, on any device, whatever the config's size."""
    params = model.abstract()
    return TrainState(step=torch.zeros((), dtype=torch.int32, device="meta"),
                      params=params, opt_state=opt.init(params))


def train_state_specs(model: Model, opt: Optimizer, mesh=None
                      ) -> TrainState:
    """The partition spec of every TrainState leaf on ``mesh`` (default
    ``model.rcfg.mesh``): the parameters' own; every subtree of the
    optimizer state shaped like the parameters (AdamW's mu and nu, SGD's
    velocity) the parameters' (ZeRO: the optimizer state sharded as the
    parameters are, whatever ``RunConfig.zero1`` says, as in the
    reference); a scalar replicated."""
    pspecs = model.specs(mesh)
    abstract = abstract_train_state(model, opt)
    pdef = pytree.tree_structure(abstract.params)

    def rec(node):
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(rec(v) for v in node))
        if pytree.tree_structure(node) == pdef:
            return pspecs
        return pytree.tree_map(lambda _: P(), node)

    return TrainState(step=P(), params=pspecs,
                      opt_state=rec(abstract.opt_state))
