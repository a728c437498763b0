"""Carry parameters and caches over from the JAX package to the port.

The caller converts a reference pytree — nested dicts of arrays — to
numpy first (``jax.tree.map(np.asarray, p)``). ``tree_from_jax`` keeps the
nesting (the LM ``Model`` takes such trees: stacked group leaves, the f32
``lam``, the caches' 0-d ``len`` counters); ``params_from_jax`` joins the
nesting with dots into a state dict (``{"mixer": {"wq": a}}`` ->
``"mixer.wq"``) for ``nn.Module``s such as the node18 block. The
``(in, out)`` weight layout is kept, so ``x @ w`` is the same product on
both sides. ``train_state_from_jax`` carries a reference ``TrainState``
(step, params and the AdamW or SGD state) into the port's, so one train
step can be compared on the same state. ``tree_from_jax(..., mesh=,
defs=)`` places the carried leaves on a mesh as ``Model.init`` does.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device


def tree_from_jax(tree: Any, device="cuda", prefix: str = "", *,
                  mesh: Any = None, defs: Any = None) -> Any:
    """Nested dict of numpy arrays -> the same nesting of tensors on
    ``device`` (copies, dtypes kept). With a ``mesh`` each leaf is placed
    as ``Model.init`` places it there: a DTensor by the logical axes of
    its ParamDef in ``defs`` (the model's ``defs`` or ``cache_defs``)
    under ``DEFAULT_TRAIN_RULES``, each rank keeping its own block."""
    out = _tree_from_jax(tree, device, prefix)
    if mesh is None:
        return out
    from repro_torch.distributed.sharding import DEFAULT_TRAIN_RULES
    from repro_torch.models.common import place_params

    if defs is None:
        raise ValueError(
            "tree_from_jax(..., mesh=) places leaves by their ParamDefs: "
            "pass defs= (the model's defs)")
    return place_params(out, defs, DEFAULT_TRAIN_RULES, mesh)


def _tree_from_jax(tree: Any, device, prefix: str) -> Any:
    dev = resolve_device(device)
    if not isinstance(tree, dict):
        raise ValueError(
            f"tree_from_jax expects nested dicts of arrays; got "
            f"{type(tree).__name__} at {prefix or 'the root'!r}")
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = _tree_from_jax(val, dev, f"{prefix}{key}.")
        else:
            arr = np.array(np.asarray(val), copy=True)
            out[key] = torch.from_numpy(arr).to(dev)
    return out


def _flatten(tree: Any, prefix: str, out: Dict[str, torch.Tensor]) -> None:
    for key, val in tree.items():
        if isinstance(val, dict):
            _flatten(val, f"{prefix}{key}.", out)
        else:
            out[f"{prefix}{key}"] = val


def params_from_jax(tree: Any, device="cuda",
                    prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays -> {"a.b": tensor} on ``device``."""
    out: Dict[str, torch.Tensor] = {}
    _flatten(tree_from_jax(tree, device, prefix), prefix, out)
    return out


def train_state_from_jax(state: Any, device="cuda"):
    """A reference ``TrainState`` of numpy arrays (``jax.tree.map(
    np.asarray, state)`` keeps its named tuples) -> the port's
    ``TrainState`` on ``device``: the step, the params tree, and
    ``AdamWState`` (step, mu, nu) or ``SGDState`` (step, velocity)."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.optim.sgd import SGDState
    from repro_torch.train.state import TrainState

    dev = resolve_device(device)

    def scalar(x):
        return torch.from_numpy(np.array(np.asarray(x), copy=True)).to(dev)

    opt = state.opt_state
    kind = type(opt).__name__
    if kind == "AdamWState":
        opt_state = AdamWState(step=scalar(opt.step),
                               mu=tree_from_jax(opt.mu, dev),
                               nu=tree_from_jax(opt.nu, dev))
    elif kind == "SGDState":
        opt_state = SGDState(step=scalar(opt.step),
                             velocity=tree_from_jax(opt.velocity, dev))
    else:
        raise ValueError(
            f"train_state_from_jax carries AdamWState or SGDState; got "
            f"{kind}")
    return TrainState(step=scalar(state.step),
                      params=tree_from_jax(state.params, dev),
                      opt_state=opt_state)
