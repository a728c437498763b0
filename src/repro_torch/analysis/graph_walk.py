"""Run-time recording and autograd-graph walking for the port's analyzer.

The counterpart of ``repro/analysis/jaxpr_walk.py``. The reference traces
each entry point to a jaxpr and walks its equations; the port has no
jaxpr, so it **runs** the entry point on small tensors and watches:

* **Depth-aware op recording** — ``Recorder`` is a ``TorchDispatchMode``
  that sees every aten and c10d op of the run, and it pushes itself onto
  ``kernels/cost_hooks.py`` (as ``launch/op_cost.OpCost`` does), where
  every loop of the solver reports ``loop_enter(kind)`` / ``trial(carry)``
  / ``loop_exit()``. So each op it keeps (host reads, collectives,
  float-width casts) carries its loop depth, the innermost loop and the
  iteration it ran in. The hand kernels' calls reach it through
  ``cost_hooks.run_kernel`` (their plain versions run paused: a CPU run
  and a card run see the same ops).

* **Host reads, whatever the device** — ``aten._local_scalar_dense`` (a
  tensor's truth value, ``int``/``float``/``.item()``), ``aten.equal``,
  ``aten.is_nonzero``, ``aten.nonzero``, a device-to-host copy, and
  ``Tensor.tolist`` / ``.numpy`` / ``.cpu`` (patched while recording: on
  CPU tensors they dispatch nothing, on the card they copy), each counted
  once.

* **Provenance** — each kept op is attributed to the innermost frame
  outside torch, the standard library and this package: a line of
  ``repro_torch`` for the solver's own ops, the caller's file for code
  injected by a test.

* **Residual recovery** — ``engine_functions(outputs)`` walks
  ``grad_fn.next_functions`` from a forward's outputs to the solver
  engines' ``autograd.Function`` nodes (``_AcaSolve``,
  ``_AcaSolveBatched``, ``_AdjointSolve``, ``_MaliSolve``): the outermost
  custom Functions, passing through the distributed layer's Functions and
  never into the kernels' own. ``residual_info(node)`` counts the bytes
  the node keeps for its backward: its saved tensors **and** every tensor
  held in its context's attributes (``ctx.ts``, ``ctx.arg_leaves``, the
  problem record), so nothing hides outside ``save_for_backward``.
"""

from __future__ import annotations

import os
import sys
import sysconfig
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import cost_hooks

#: aten ops that read a tensor's value on the host
HOST_READ_OPS = frozenset({"_local_scalar_dense", "is_nonzero", "equal",
                           "nonzero"})
#: Tensor methods that read on the host (patched while a Recorder runs)
HOST_READ_METHODS = ("tolist", "numpy", "cpu")
#: aten ops that cast (a float-width change between input and output)
CAST_OPS = frozenset({"_to_copy", "copy_", "copy"})


# --------------------------------------------------------------- provenance

def _norm(path: str) -> str:
    return path.replace("\\", "/")


_SKIP_DIRS = tuple(sorted({
    _norm(os.path.dirname(torch.__file__)) + "/",
    _norm(sysconfig.get_paths()["stdlib"]) + "/",
    _norm(os.path.dirname(os.path.abspath(__file__))) + "/",
    _norm(os.path.abspath(cost_hooks.__file__)),
}))


def short_path(path: str) -> str:
    """``repro_torch/...`` for a file of the package, else the path."""
    p = _norm(path)
    i = p.rfind("/repro_torch/")
    return p[i + 1:] if i >= 0 else p


def provenance() -> Tuple[str, int, str]:
    """(file, line, function) of the innermost frame outside torch, the
    standard library, this package and the hook registry."""
    f = sys._getframe(1)
    while f is not None:
        fn = _norm(f.f_code.co_filename)
        if not fn.startswith(_SKIP_DIRS) and not fn.startswith("<"):
            return short_path(fn), f.f_lineno, f.f_code.co_name
        f = f.f_back
    return "<unknown>", 0, ""


# ----------------------------------------------------------------- records

@dataclass
class Event:
    """One kept op: a host read, a collective, a float-width cast or a
    carry whose dtype changed."""

    kind: str            # "read", "collective", "cast", "carry"
    op: str
    depth: int           # enclosing loops
    loop: Optional[int]  # index of the innermost loop in Recorder.loops
    iteration: int       # its iteration; -1 before the first (entry test)
    path: str
    line: int
    func: str
    detail: str = ""


@dataclass
class LoopRecord:
    """One loop instance as the hooks reported it."""

    kind: str
    depth: int                    # 1 for an outermost loop
    path: str
    line: int
    func: str
    entry_reads: int = 0          # reads before the first iteration
    reads: List[int] = field(default_factory=list)   # per iteration
    carry_dtypes: Optional[Tuple[str, ...]] = None   # at the first one

    @property
    def iterations(self) -> int:
        return len(self.reads)

    @property
    def max_reads(self) -> int:
        return max(self.reads, default=0)


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in pytree.tree_leaves(tree)
            if isinstance(x, torch.Tensor)]


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


class Recorder(TorchDispatchMode):
    """Records one run's host reads, collectives and casts with their loop
    depth, and its loops (see the module docstring)::

        with Recorder() as rec:
            ys, _ = odeint(...)
            ys.sum().backward()
        rec.events, rec.loops, rec.kernels
    """

    def __init__(self):
        super().__init__()
        self.events: List[Event] = []
        self.loops: List[LoopRecord] = []
        self.kernels: Dict[str, int] = {}
        self._open: List[int] = []     # indices of the open loops
        self._reading = 0              # inside a patched read method
        self._saved_methods: Dict[str, Any] = {}

    # ---------------------------------------------------------- context
    def __enter__(self):
        self._patch_methods()
        cost_hooks.push(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            cost_hooks.pop(self)
            self._unpatch_methods()
            self._open.clear()

    def _patch_methods(self) -> None:
        rec = self
        for name in HOST_READ_METHODS:
            orig = getattr(torch.Tensor, name)
            # None: inherited from the C base class, deleted again on exit
            self._saved_methods[name] = torch.Tensor.__dict__.get(name)

            def read(t, *a, _orig=orig, _name=name, **k):
                if rec._reading or cost_hooks.is_paused():
                    return _orig(t, *a, **k)
                rec._event("read", _name, provenance())
                rec._reading += 1
                try:
                    return _orig(t, *a, **k)
                finally:
                    rec._reading -= 1

            setattr(torch.Tensor, name, read)

    def _unpatch_methods(self) -> None:
        for name, orig in self._saved_methods.items():
            if orig is None:
                delattr(torch.Tensor, name)
            else:
                setattr(torch.Tensor, name, orig)
        self._saved_methods.clear()

    # ---------------------------------------------------------- records
    def _event(self, kind: str, op: str, where: Tuple[str, int, str],
               detail: str = "") -> None:
        loop = self._open[-1] if self._open else None
        it = self.loops[loop].iterations - 1 if loop is not None else -1
        if kind == "read" and loop is not None:
            rec = self.loops[loop]
            if it < 0:
                rec.entry_reads += 1
            else:
                rec.reads[it] += 1
        self.events.append(Event(kind, op, len(self._open), loop, it,
                                 *where, detail))

    # ------------------------------------------------- cost_hooks protocol
    def _kernel_entry(self, name: str, work: Any) -> None:
        self.kernels[name] = self.kernels.get(name, 0) + 1

    def _kernel_exit(self, out: Any, inputs) -> None:
        pass

    def _loop_enter(self, kind: str = "trial", dynamic: bool = True) -> None:
        self.loops.append(LoopRecord(kind, len(self._open) + 1,
                                     *provenance()))
        self._open.append(len(self.loops) - 1)

    def _trial(self, carry: Any = None) -> None:
        if not self._open:
            return
        rec = self.loops[self._open[-1]]
        rec.reads.append(0)
        if carry is None:
            return
        dtypes = tuple(_dtype_name(t.dtype) for t in _tensors(carry))
        if rec.carry_dtypes is None:
            rec.carry_dtypes = dtypes
        elif dtypes != rec.carry_dtypes:
            self._event("carry", rec.kind, provenance(),
                        f"{rec.carry_dtypes} -> {dtypes}")

    def _loop_exit(self) -> None:
        if self._open:
            self._open.pop()

    # ---------------------------------------------------------- dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if cost_hooks.is_paused() or self._reading:
            return out
        name = func._overloadpacket.__name__
        if func.namespace.startswith(("c10d", "_c10d")):
            kind = cost_hooks.collective_kind(name)
            if kind is not None:
                self._event("collective", kind, provenance(), name)
            return out
        if name in HOST_READ_OPS:
            self._event("read", name, provenance())
        elif name in CAST_OPS:
            self._cast(name, args, out)
        return out

    def _cast(self, name: str, args, out) -> None:
        ins = _tensors(args)
        outs = _tensors(out)
        if not ins or not outs:
            return
        src = ins[-1] if name != "_to_copy" else ins[0]
        dst = outs[0]
        if src.device.type != "cpu" and dst.device.type == "cpu":
            self._event("read", f"{name}(to cpu)", provenance())
        if (src.dtype.is_floating_point and dst.dtype.is_floating_point
                and src.dtype.itemsize != dst.dtype.itemsize):
            self._event("cast", name, provenance(),
                        f"{_dtype_name(src.dtype)}->"
                        f"{_dtype_name(dst.dtype)}")

    # ---------------------------------------------------------- queries
    def of(self, kind: str) -> List[Event]:
        return [e for e in self.events if e.kind == kind]


# ------------------------------------------------------- residual recovery

def _is_custom(node) -> Optional[type]:
    return getattr(node, "_forward_cls", None)


def engine_functions(outputs) -> List[Any]:
    """The outermost solver-engine ``autograd.Function`` nodes behind
    ``outputs`` (a tensor or a pytree of them), in the order found.

    A custom Function of ``repro_torch.kernels`` is never entered (its
    residuals belong to the engine that saved them); one of
    ``repro_torch.distributed`` (the sharded solve's take / gather /
    replicate moves) is passed through; any other custom Function is an
    engine and ends its branch.
    """
    roots = [t.grad_fn for t in _tensors(outputs) if t.grad_fn is not None]
    seen, found = set(), []
    queue = list(roots)
    while queue:
        node = queue.pop(0)
        if node is None or node in seen:
            continue
        seen.add(node)
        cls = _is_custom(node)
        if cls is not None:
            mod = getattr(cls, "__module__", "")
            if mod.startswith("repro_torch.kernels"):
                continue
            if not mod.startswith("repro_torch.distributed"):
                found.append(node)
                continue
        queue.extend(fn for fn, _ in node.next_functions)
    return found


@dataclass
class ResidualInfo:
    """What one engine node keeps for its backward."""

    node: Any
    named_leaves: List[Tuple[str, torch.Tensor]]
    path: str
    line: int

    @property
    def total_bytes(self) -> int:
        return sum(_nbytes(t) for _, t in self.named_leaves)

    def bytes_by_leaf(self) -> Dict[str, int]:
        return {p: _nbytes(t) for p, t in self.named_leaves}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _saved_names(node, n: int) -> List[str]:
    """Names of the saved tensors: the checkpoint fields of ACA
    (``ctx.ckpt_names``), z0 and the grid fields of MALI (``ctx.counts``),
    the outputs of the adjoint."""
    groups: List[Tuple[str, int]] = []
    if hasattr(node, "ckpt_names"):
        groups = [(f".ckpts.{k}", c) for k, c in node.ckpt_names]
    elif hasattr(node, "counts"):
        from repro_torch.core.odeint_mali import _GRID

        groups = [(f".grid.{k}" if i else ".z0", c) for i, (k, c) in
                  enumerate(zip(("z0",) + tuple(_GRID), node.counts))]
    elif type(node).__name__.startswith("_AdjointSolve"):
        groups = [(".ys", n)]
    else:
        groups = [(".saved", n)]
    names = []
    for k, c in groups:
        names += [k] if c == 1 else [f"{k}[{g}]" for g in range(c)]
    names += [f".saved[{i}]" for i in range(len(names), n)]
    return names[:n]


def _key(t: torch.Tensor):
    ptr = t.data_ptr()
    if ptr == 0:
        return ("id", id(t))
    return (ptr, t.dtype, tuple(t.shape), tuple(t.stride()),
            t.storage_offset())


def _held(value: Any, name: str, depth: int = 0
          ) -> Iterator[Tuple[str, torch.Tensor]]:
    """Tensors reachable from a context attribute: through containers and
    the package's own records (not functions, modules or torch objects)."""
    if depth > 4:
        return
    if isinstance(value, torch.Tensor):
        yield name, value
    elif isinstance(value, tuple) and hasattr(value, "_fields"):
        for k in value._fields:
            yield from _held(getattr(value, k), f"{name}.{k}", depth + 1)
    elif isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            yield from _held(v, f"{name}[{i}]", depth + 1)
    elif isinstance(value, dict):
        for k, v in value.items():
            yield from _held(v, f"{name}[{k!r}]", depth + 1)
    elif type(value).__module__.startswith("repro_torch") \
            and hasattr(value, "__dict__") and not callable(value):
        for k, v in vars(value).items():
            yield from _held(v, f"{name}.{k}", depth + 1)


def residual_info(node) -> ResidualInfo:
    """The tensors one engine node keeps for its backward, each once:
    ``saved_tensors`` (named by the engine's records) and every tensor
    reachable from the context's attributes."""
    saved = list(node.saved_tensors)
    named = list(zip(_saved_names(node, len(saved)), saved))
    for k, v in vars(node).items():
        named += list(_held(v, f".{k}"))
    seen, leaves = set(), []
    for name, t in named:
        key = _key(t)
        if key not in seen:
            seen.add(key)
            leaves.append((name, t))
    cls = _is_custom(node)
    path, line = "<unknown>", 0
    fwd = getattr(cls, "forward", None)
    code = getattr(fwd, "__code__", None)
    if code is not None:
        path, line = short_path(code.co_filename), code.co_firstlineno
    return ResidualInfo(node=node, named_leaves=leaves, path=path, line=line)
