"""Op-counting cost model of one rank: FLOPs by dtype, bytes, collectives.

The counterpart of ``repro/launch/hlo_cost.py``. The reference walks
XLA's optimized HLO text; the port has no HLO, so it counts the ops as
they run. ``OpCost`` is a ``TorchDispatchMode``: every aten op dispatched
inside ``with OpCost() as c:`` is seen once, on real tensors (the card,
the CPU) or on fake ones (``FakeTensorMode``: shapes only, nothing
allocated), and

  * **flops**: the op's FLOPs by ``torch.utils.flop_counter``'s formulas
    (matmuls, convolutions, attention: the class the reference's ``dot``
    counting covers), keyed by the operands' dtype (``flops_by_dtype``);
  * **bytes**: every op's tensor operands plus results (views and
    allocations move nothing); **bytes_min** only the reference's
    ``_ESSENTIAL_OPS`` class: matmuls, convolutions, reductions, gather
    and index (twice the slice), scatter (three times the update), index
    and slice updates (twice the update), sort, collectives and the hand
    kernels;
  * **collectives** by kind (all-reduce, all-gather, reduce-scatter,
    all-to-all, collective-permute): the ring factor times the larger of
    result and operand, as ``roofline.collective_bytes`` takes them;
  * **peak_bytes**: the most bytes held at once by storages made inside
    the context (each freed when its last tensor dies);
  * **breakdown**: per scope (the innermost ``repro_torch`` function
    below the op, ``file:function``; ``kernel:<name>`` for a hand
    kernel), its op count, FLOPs, bytes and collective bytes;
  * **dynamic_whiles**: entries into a data-dependent trial loop of
    ``core/integrate.py`` (``cost_hooks.loop_enter``), and
    ``flops_body_once`` / ``bytes_body_once``, what the first trial of
    the first such loop counted. Eager execution counts every trial, so no total needs
    scaling by trips.

**One rank.** On a ``DeviceMesh`` the counter declines DTensor-level ops
(``NotImplemented``), so DTensor desugars them into the rank's local ops
and collectives and the counter sees those; the global-shape ops that
DTensor's sharding propagation runs to learn output shapes are not
counted. A counter over a sharded call therefore holds one rank's work.

**Hand kernels.** K1-K10 are ctypes calls no dispatch mode can see. Each
wrapper asks ``kernels/cost_hooks.active()`` first (the registry this
counter pushes itself onto while it runs) and, under a counter, hands
the call to ``cost_hooks.run_kernel`` with its ``work(...)``: one entry with
that FLOP and byte count, whichever route runs (kernel, plain version on the CPU, or
the plain version on fake tensors, which launches nothing); the plain
version's own ops are not counted. With no counter running, ``active()``
is one global read and nothing else changes.
"""

from __future__ import annotations

import sys
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost_hooks

COLL_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0, "collective-permute": 1.0}

DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float16: "f16",
               torch.float32: "f32", torch.float64: "f64"}

# the reference's _ESSENTIAL_OPS, as aten op names
_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "addmv", "mv", "dot",
           "vdot", "convolution", "_convolution", "convolution_backward",
           "_scaled_dot_product_efficient_attention",
           "_scaled_dot_product_flash_attention",
           "_scaled_dot_product_cudnn_attention",
           "_scaled_dot_product_flash_attention_for_cpu",
           "_scaled_dot_product_efficient_attention_backward",
           "_scaled_dot_product_flash_attention_backward",
           "_scaled_dot_product_flash_attention_for_cpu_backward",
           "_scaled_mm", "_grouped_mm"}
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp",
           "var", "std", "var_mean", "std_mean", "norm", "linalg_vector_norm",
           "any", "all", "argmax", "argmin", "cumsum", "cumprod", "cummax",
           "_softmax", "_log_softmax", "_softmax_backward_data",
           "_log_softmax_backward_data", "nll_loss_forward",
           "nll_loss_backward", "native_layer_norm",
           "native_layer_norm_backward", "_fused_rms_norm",
           "_fused_rms_norm_backward", "sort", "topk", "argsort", "kthvalue"}
_GATHER = {"gather", "index", "index_select", "embedding", "take",
           "masked_select"}
_SCATTER = {"scatter", "scatter_", "scatter_add", "scatter_add_",
            "scatter_reduce", "scatter_reduce_", "index_add", "index_add_",
            "index_copy", "index_copy_", "embedding_dense_backward"}
_UPDATE = {"index_put", "index_put_", "_index_put_impl_", "slice_scatter",
           "select_scatter", "copy_", "masked_scatter", "masked_scatter_"}
# ops that move no bytes of their own
_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "detach", "alias", "lift_fresh", "device",
         "wait_tensor", "_local_scalar_dense", "set_", "resize_",
         "record_stream"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in pytree.tree_leaves(tree)
            if isinstance(x, torch.Tensor)]


def dtype_name(dtype: torch.dtype) -> str:
    return DTYPE_NAMES.get(dtype, str(dtype).replace("torch.", ""))


def _scope(depth: int = 2) -> str:
    """``file:function`` of the innermost repro_torch frame below the op
    (skipping this module and the distributed plumbing)."""
    f = sys._getframe(depth)
    while f is not None:
        fn = f.f_code.co_filename
        if "repro_torch" in fn and "op_cost" not in fn \
                and "distributed" not in fn:
            path = fn.replace("\\", "/").split("repro_torch/")[-1]
            return f"{path}:{f.f_code.co_name}"
        f = f.f_back
    return "(outside repro_torch)"


def _propagation_patch():
    """DTensor's sharding propagation and its shard arithmetic are no
    rank's work: propagation runs each op once on global-shape fake
    tensors to learn its output's shape, and both propagation and
    ``_StridedShard``'s shard sizes build small index tensors and read
    them back. These run paused (not counted) and outside any
    ``FakeTensorMode`` (whose tensors cannot be read back). Returns
    (install, remove)."""
    try:
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        from torch.distributed.tensor.placement_types import _StridedShard
    except ImportError:          # no torch.distributed: nothing to patch
        return (lambda: None), (lambda: None)
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    meta = "_propagate_tensor_meta_non_cached"
    if meta not in ShardingPropagator.__dict__:
        raise RuntimeError(
            "OpCost: torch.distributed.tensor's ShardingPropagator has no "
            f"{meta}; the counter cannot tell shape propagation from a "
            "rank's work in this torch version")
    origs = [(cls, n, cls.__dict__[n]) for cls, n in (
        (ShardingPropagator, meta),
        (ShardingPropagator, "propagate_op_sharding_non_cached"),
        (_StridedShard, "local_shard_size_and_offset"))
        if callable(cls.__dict__.get(n))]

    def wrap(orig):
        def paused(*a, **k):
            with cost_hooks.paused(), unset_fake_temporarily():
                return orig(*a, **k)
        return paused

    def install():
        for cls, n, f in origs:
            setattr(cls, n, wrap(f))

    def remove():
        for cls, n, f in origs:
            setattr(cls, n, f)

    return install, remove


class OpCost(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the work of one rank (see the module docstring)::

        with OpCost() as c:
            model.prefill(params, batch)
        c.flops, c.flops_by_dtype, c.bytes_min, c.coll, c.peak_bytes
    """

    def __init__(self):
        super().__init__()
        self.flops_by_dtype: Dict[str, float] = {}
        self.bytes = 0.0
        self.bytes_min = 0.0
        self.coll: Dict[str, float] = {}
        self.coll_count: Dict[str, int] = {}
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.dynamic_whiles = 0
        self.flops_body_once = 0.0
        self.bytes_body_once = 0.0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._seen = weakref.WeakKeyDictionary()
        self._rows: Dict[str, List[float]] = {}
        self._body: Optional[str] = None     # None, "armed", "open", "done"
        self._body_start = (0.0, 0.0)     # (flops, bytes_min) at its start
        self._patch = None
        self._coll_records: List[Tuple[str, int, int]] = []
        self._loops: List[bool] = []      # open loops: dynamic or not

    # ---------------------------------------------------------- totals
    @property
    def flops(self) -> float:
        return float(sum(self.flops_by_dtype.values()))

    def coll_total(self) -> float:
        return float(sum(self.coll.values()))

    @property
    def breakdown(self) -> List[Tuple[str, float, float, float, float]]:
        """(scope, ops, flops, bytes, coll_bytes), the largest first (by
        FLOPs plus collective bytes, as the reference sorts), top 40."""
        rows = sorted(((k, *v) for k, v in self._rows.items()),
                      key=lambda r: (-(r[2] + r[4]), -r[3]))
        return [tuple(r) for r in rows[:40]]

    def collectives(self) -> List[Tuple[str, int, int]]:
        return list(self._coll_records)

    # ------------------------------------------------------ context
    def __enter__(self):
        if not any(getattr(c, "_patch", None)
                   for c in cost_hooks.running()):
            self._patch = _propagation_patch()
            self._patch[0]()
        cost_hooks.push(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            cost_hooks.pop(self)
            if self._patch is not None:
                self._patch[1]()
                self._patch = None
            if self._body == "open":
                self._close_body()

    # ------------------------------------------------------ recording
    def _row(self, scope: str) -> List[float]:
        return self._rows.setdefault(scope, [0.0, 0.0, 0.0, 0.0])

    def _add(self, scope: str, flops: Dict[str, float], nbytes: float,
             essential: float, coll: float = 0.0) -> None:
        for k, v in flops.items():
            self.flops_by_dtype[k] = self.flops_by_dtype.get(k, 0.0) + v
        self.bytes += nbytes
        self.bytes_min += essential
        r = self._row(scope)
        r[0] += 1
        r[1] += sum(flops.values())
        r[2] += nbytes
        r[3] += coll

    def _hold(self, tensors, inputs=()) -> None:
        """Count the storages of ``tensors`` as held from now until their
        last tensor dies, except those of ``inputs`` (an in-place result
        or a view allocates nothing)."""
        given = []
        for t in inputs:
            try:
                given.append(t.untyped_storage())
            except (RuntimeError, NotImplementedError):
                pass
        for t in tensors:
            try:
                st = t.untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue
            if st in self._seen or any(st is g for g in given):
                continue
            n = st.nbytes()
            self._seen[st] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._release, n)

    def _release(self, n: int) -> None:
        self.live_bytes -= n

    def _kernel_entry(self, name: str,
                      work: Tuple[Dict[str, float], float]) -> None:
        flops, nbytes = work
        self._add(f"kernel:{name}", flops, nbytes, nbytes)
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0.0,
                                           "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += sum(flops.values())
        k["bytes"] += nbytes

    def _kernel_exit(self, out: Any, inputs) -> None:
        self._hold(_tensors(out), inputs)

    def _loop_enter(self, kind: str = "trial", dynamic: bool = True) -> None:
        # only the data-dependent trial loops count; the other loops the
        # hooks report (fixed grids, sweeps) are ignored, whatever they hold
        self._loops.append(dynamic)
        if not dynamic:
            return
        self.dynamic_whiles += 1
        if self._body is None:
            self._body = "armed"
        elif self._body == "open":
            self._close_body()

    def _trial(self, carry: Any = None) -> None:
        if self._loops and not self._loops[-1]:
            return
        if self._body == "armed":
            self._body = "open"
            self._body_start = (self.flops, self.bytes_min)
        elif self._body == "open":
            self._close_body()

    def _loop_exit(self) -> None:
        if self._loops and not self._loops.pop():
            return
        if self._body == "open":
            self._close_body()

    def _close_body(self) -> None:
        self.flops_body_once = self.flops - self._body_start[0]
        self.bytes_body_once = self.bytes_min - self._body_start[1]
        self._body = "done"

    # ------------------------------------------------------ dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(getattr(t, "__name__", "") == "DTensor" for t in types):
            return NotImplemented      # let DTensor desugar to local ops
        out = func(*args, **kwargs)
        if cost_hooks.is_paused():
            return out
        name = func._overloadpacket.__name__
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        self._hold(outs, ins)
        scope = _scope()
        kind = cost_hooks.collective_kind(name) if func.namespace.startswith(
            ("c10d", "_c10d")) else None
        if kind is not None:
            res = sum(_nbytes(t) for t in outs)
            opnd = sum(_nbytes(t) for t in ins)
            moved = COLL_FACTOR[kind] * max(res, opnd)
            self.coll[kind] = self.coll.get(kind, 0.0) + moved
            self.coll_count[kind] = self.coll_count.get(kind, 0) + 1
            self._coll_records.append((kind, res, opnd))
            self._add(scope, {}, moved, moved, moved)
            return out
        if name in _FREE or func.is_view:
            return out
        flops = {}
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            def shape(x):
                return x.shape if isinstance(x, torch.Tensor) else x
            n = formula(*pytree.tree_map(shape, args),
                        **pytree.tree_map(shape, kwargs),
                        out_val=pytree.tree_map(shape, out))
            if n:
                flops[dtype_name(ins[0].dtype if ins else outs[0].dtype)] \
                    = float(n)
        if name in _GATHER:
            moved = 2.0 * sum(_nbytes(t) for t in outs)
            essential = moved
        elif name in _SCATTER:
            src = ins[-1] if ins else None
            moved = 3.0 * (_nbytes(src) if src is not None else 0)
            essential = moved
        elif name in _UPDATE:
            src = ins[-1] if len(ins) > 1 else None
            moved = 2.0 * (_nbytes(src) if src is not None else
                           sum(_nbytes(t) for t in outs))
            essential = moved
        else:
            moved = float(sum(_nbytes(t) for t in ins)
                          + sum(_nbytes(t) for t in outs))
            essential = moved if (name in _MATMUL or name in _REDUCE
                                  or formula is not None) else 0.0
        self._add(scope, flops, moved, essential)
        return out
