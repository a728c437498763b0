"""Carry parameters and caches over from the JAX package to the port.

The caller converts a reference pytree — nested dicts of arrays — to
numpy first (``jax.tree.map(np.asarray, p)``). ``tree_from_jax`` keeps the
nesting (the LM ``Model`` takes such trees: stacked group leaves, the f32
``lam``, the caches' 0-d ``len`` counters); ``params_from_jax`` joins the
nesting with dots into a state dict (``{"mixer": {"wq": a}}`` ->
``"mixer.wq"``) for ``nn.Module``s such as the node18 block. The
``(in, out)`` weight layout is kept, so ``x @ w`` is the same product on
both sides.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device


def tree_from_jax(tree: Any, device="cuda", prefix: str = "") -> Any:
    """Nested dict of numpy arrays -> the same nesting of tensors on
    ``device`` (copies, dtypes kept)."""
    dev = resolve_device(device)
    if not isinstance(tree, dict):
        raise ValueError(
            f"tree_from_jax expects nested dicts of arrays; got "
            f"{type(tree).__name__} at {prefix or 'the root'!r}")
    out = {}
    for key, val in tree.items():
        if isinstance(val, dict):
            out[key] = tree_from_jax(val, dev, prefix=f"{prefix}{key}.")
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
