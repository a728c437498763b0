"""Deterministic fault injection for the port's solve-health tests: a torch
port of ``tests/faults.py``.

``faulty_field`` wraps a vector field ``f(t, z, *args)`` so that it emits
a corruption (NaN, Inf, or a finite 1e30 spike) once the integration
clock enters a trigger window. The trigger is a ``torch.where`` on the
clock (no host branch), so the wrapped field keeps ``f``'s signature and
runs under every gradient method, under ``torch.func.vmap`` (the batched
engines) and on any device. The corrupted value replaces the field's
output, so one accepted step inside the window poisons the state: what
the guards must detect (``SolveStatus.NONFINITE_STATE``) and freeze.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

_KINDS = ("nan", "inf", "spike")
_SPIKE = 1e30


def fault_value(kind: str) -> float:
    """What a faulted leaf is overwritten with: ``"nan"`` NaN, ``"inf"``
    +Inf, ``"spike"`` 1e30 (finite, but one RK stage overflows the state
    downstream)."""
    if kind == "nan":
        return float("nan")
    if kind == "inf":
        return float("inf")
    if kind == "spike":
        return _SPIKE
    raise ValueError(f"kind must be one of {_KINDS}; got {kind!r}")


def faulty_field(f: Callable, kind: str = "nan", t_ge: float = 0.5,
                 t_until: Optional[float] = None,
                 predicate: Optional[Callable] = None) -> Callable:
    """Wrap ``f`` to emit ``kind`` whenever ``t`` is in ``[t_ge, t_until)``
    (``t_until=None``: open-ended). ``predicate(t, z) -> bool tensor``
    further gates the trigger (e.g. one batch element, matched by its
    state)."""
    value = fault_value(kind)

    def wrapped(t, z, *args):
        out = f(t, z, *args)
        trig = torch.as_tensor(t) >= t_ge
        if t_until is not None:
            trig = trig & (torch.as_tensor(t) < t_until)
        if predicate is not None:
            trig = trig & predicate(t, z)
        return pytree.tree_map(
            lambda leaf: torch.where(trig, torch.full_like(leaf, value),
                                     leaf), out)

    return wrapped
