"""Where the hand kernels and the solver's trial loops meet a cost counter.

A counter (``launch/op_cost.OpCost``) pushes itself here while it runs;
the kernel wrappers ask ``active()`` and hand their call to its
``kernel(name, work, run, inputs)``, and ``core/integrate.py``'s
data-dependent trial loops report ``loop_enter`` / ``trial`` /
``loop_exit``. So nothing below ``launch`` imports ``launch``: this
module needs only the standard library. With no counter running, each
hook is one read of a list and nothing else.
"""

from __future__ import annotations

import contextlib
from typing import Any, List, Optional

_stack: List[Any] = []       # running counters, innermost last
_paused = 0                  # > 0 inside a kernel entry or propagation


def push(counter: Any) -> None:
    _stack.append(counter)


def pop(counter: Any) -> None:
    _stack.remove(counter)


def running() -> List[Any]:
    """The running counters, outermost first (whether paused or not)."""
    return list(_stack)


@contextlib.contextmanager
def paused():
    """No counter sees what runs inside (a kernel's plain version, shape
    propagation)."""
    global _paused
    _paused += 1
    try:
        yield
    finally:
        _paused -= 1


def is_paused() -> bool:
    return _paused > 0


def active() -> Optional[Any]:
    """The innermost running counter, or None (also while paused: a
    kernel's own ops are not counted)."""
    if not _stack or _paused:
        return None
    return _stack[-1]


def loop_enter() -> None:
    """A data-dependent trial loop starts (``core/integrate.py``)."""
    if _stack and not _paused:
        for c in _stack:
            c._loop_enter()


def trial() -> None:
    """A trial of the loop last entered starts."""
    if _stack and not _paused:
        for c in _stack:
            c._trial()


def loop_exit() -> None:
    """The loop last entered ends (closes a first trial still open)."""
    if _stack and not _paused:
        for c in _stack:
            c._loop_exit()
