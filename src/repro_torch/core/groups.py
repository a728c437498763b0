"""Dtype groups: the engines' form of a state whose leaves mix dtypes.

An engine's state is one tensor, or (a pytree whose leaves mix floating
dtypes, raveled by ``stepper.maybe_flatten``) the tuple of its G dtype
groups, one flat tensor per dtype. These helpers apply one operation to
either form; on one tensor each is that operation itself, so a one-dtype
solve runs the operations it ran before groups existed.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def gleaves(z) -> list:
    """The tensors of an engine state: [z], or its groups."""
    return [z] if isinstance(z, torch.Tensor) else list(z)


def ungroup(parts):
    """The inverse of ``gleaves``: one tensor, or the tuple of groups."""
    return parts[0] if len(parts) == 1 else tuple(parts)


def gmap(fn: Callable, *zs):
    """``fn`` over the groups of one or more states of the same form."""
    if isinstance(zs[0], torch.Tensor):
        return fn(*zs)
    return tuple(fn(*parts) for parts in zip(*zs))


def gget(buf, idx):
    """``buf[idx]`` of each group."""
    return gmap(lambda b: b[idx], buf)


def gset(buf, idx, val) -> None:
    """``buf[idx] = val`` in each group, in place."""
    for b, v in zip(gleaves(buf), gleaves(val)):
        b[idx] = v


def gstack(states):
    """``torch.stack`` of a list of states, group by group."""
    if isinstance(states[0], torch.Tensor):
        return torch.stack(states)
    return tuple(torch.stack(parts) for parts in zip(*states))


def gunbind(z) -> list:
    """The states along axis 0 (``unbind``), group by group."""
    if isinstance(z, torch.Tensor):
        return list(z.unbind(0))
    return list(zip(*(g.unbind(0) for g in z)))


def gdetach(z):
    return gmap(torch.Tensor.detach, z)


def gzeros(lead: Tuple[int, ...], z, keep: int = 0):
    """Zeros of shape ``lead`` + each group's shape after its first
    ``keep`` axes, in the group's dtype and on its device."""
    return gmap(lambda x: torch.zeros(tuple(lead) + tuple(x.shape[keep:]),
                                      dtype=x.dtype, device=x.device), z)
