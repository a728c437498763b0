"""Where the hand kernels and the solver's trial loops meet a cost counter.

A counter (``launch/op_cost.OpCost``, ``analysis/graph_walk.Recorder``)
pushes itself here while it runs; a kernel wrapper that finds a counter
``active()`` hands its call to ``run_kernel(name, work, run, inputs)``,
which fans it out to every running counter, and the solver's loops
report ``loop_enter`` / ``trial`` / ``loop_exit``. So nothing below
``launch`` imports ``launch`` or ``analysis``: this module needs only the
standard library. With no counter running, each hook is one read of a
list and nothing else.

Every loop of the solver reports: ``core/integrate.py``'s trial loops
(``dynamic=True``, the data-dependent loops ``OpCost.dynamic_whiles``
counts), and with ``dynamic=False`` the naive method's trial loops, the
fixed grids, the adjoint's reverse segments and the ACA and MALI backward
sweeps (loops the analysis sees and ``OpCost`` ignores). ``kind`` names
the loop for the analysis; ``carry`` hands it the loop's carried tensors
at the start of an iteration.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, List, Optional

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


def run_kernel(name: str, work: Any, run: Callable[[], Any],
               inputs=()) -> Any:
    """One hand-kernel call under the running counters: each records the
    entry (``_kernel_entry(name, work)``), ``run()`` computes the result
    with every counter paused, and each sees its outputs
    (``_kernel_exit(out, inputs)``)."""
    counters = running()
    for c in counters:
        c._kernel_entry(name, work)
    with paused():
        out = run()
    for c in counters:
        c._kernel_exit(out, inputs)
    return out


def collective_kind(name: str) -> Optional[str]:
    """The collective class of an aten/c10d op name, or None (waits and
    barriers move nothing)."""
    if "wait" in name or "barrier" in name:
        return None
    if "reduce_scatter" in name:
        return "reduce-scatter"
    if "all_reduce" in name or "allreduce" in name:
        return "all-reduce"
    if "all_gather" in name or "allgather" in name:
        return "all-gather"
    if "all_to_all" in name or "alltoall" in name:
        return "all-to-all"
    if name.startswith(("broadcast", "send", "recv", "permute")):
        return "collective-permute"
    return None


def loop_enter(kind: str = "trial", dynamic: bool = True) -> None:
    """A loop of ``kind`` starts; ``dynamic`` for ``core/integrate.py``'s
    data-dependent trial loops."""
    if _stack and not _paused:
        for c in _stack:
            c._loop_enter(kind, dynamic)


def trial(carry: Any = None) -> None:
    """An iteration of the loop last entered starts (``carry``: its
    carried tensors, or None)."""
    if _stack and not _paused:
        for c in _stack:
            c._trial(carry)


def loop_exit() -> None:
    """The loop last entered ends."""
    if _stack and not _paused:
        for c in _stack:
            c._loop_exit()
