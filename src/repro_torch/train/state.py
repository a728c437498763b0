"""TrainState: params + optimizer state + step.

Port of ``repro/train/state.py``'s ``TrainState`` and
``make_train_state``. The reference's ``abstract_train_state`` and
``train_state_specs`` (shape stand-ins and sharding specs for a mesh)
belong to the distributed slice.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.device import resolve_device
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
    CPU)."""
    dev = resolve_device(device)
    params = model.init(seed=seed, device=dev)
    return TrainState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      params=params, opt_state=opt.init(params))
