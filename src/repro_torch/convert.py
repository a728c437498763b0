"""Carry parameters over from the JAX package to the port.

``params_from_jax`` turns a reference parameter pytree — nested dicts of
arrays, converted to numpy by the caller (``jax.tree.map(np.asarray, p)``)
— into a state dict whose keys join the nesting with dots
(``{"mixer": {"wq": a}}`` -> ``"mixer.wq"``). The ``(in, out)`` weight
layout is kept, so ``x @ w`` is the same product on both sides.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device


def params_from_jax(tree: Any, device="cuda",
                    prefix: str = "") -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays -> {"a.b": tensor} on ``device``."""
    dev = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}
    if not isinstance(tree, dict):
        raise ValueError(
            f"params_from_jax expects nested dicts of arrays; got "
            f"{type(tree).__name__} at {prefix or 'the root'!r}")
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(params_from_jax(val, dev, prefix=name + "."))
        else:
            arr = np.asarray(val)
            out[name] = torch.from_numpy(np.array(arr, copy=True)).to(dev)
    return out
