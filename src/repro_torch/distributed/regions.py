"""Per-rank regions of the sharded LM.

The LM on a mesh runs on DTensors: parameters and activations are placed
by the logical-axis rules (``sharding.shard``) and DTensor's sharding
propagation carries most ops. Where it has no rule (a stable sort, the
MoE dispatch, flash-decode's cross-shard softmax, a vocab-sharded
cross-entropy) or where a hand-written kernel takes plain tensors (K7-K10),
the model runs plain code on each rank's local block instead, the
reference's ``shard_map`` regions written out per rank:

* ``Region(mesh, split)`` — ``split`` names the mesh dims the region's
  work is divided over (the batch's data dims when the batch is sharded;
  ``model`` where heads, channels, experts or a KV-sequence shard divide
  it);
* ``enter(x, placements)`` — ``x`` (a DTensor, or a plain tensor taken as
  the global value every rank holds) redistributed to ``placements``, as
  its local block. Its gradient is declared ``Partial`` over each split
  dim on which the input is replicated (each rank's part of the sum) and
  keeps the input's placement elsewhere, so DTensor's autograd sums the
  parts where the reference's ``shard_map`` transpose would;
* ``leave(t, placements)`` — a local result wrapped as a DTensor;
* ``all_reduce(t, op, dim)`` — an in-place, no-grad collective over one
  mesh dim (decode's flash-decode combine), counted in ``counts``.

On a one-rank mesh every placement is the whole tensor: a region runs the
mesh-less code on the same tensors, and a collective is a copy.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Sequence

import torch

from .sharding import mesh_shape

# explicit collectives issued by regions (all_reduce per reduce op)
counts: Dict[str, int] = {"all_reduce_max": 0, "all_reduce_sum": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


def is_dtensor(x: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


_depth = 0     # nesting of mesh contexts (DTensor's own does not nest)


@contextlib.contextmanager
def _replicating():
    global _depth
    if _depth:
        _depth += 1
        try:
            yield
        finally:
            _depth -= 1
        return
    from torch.distributed.tensor.experimental import implicit_replication

    with implicit_replication():
        _depth = 1
        try:
            yield
        finally:
            _depth = 0


def mesh_context(mesh: Any):
    """The context a model runs in on ``mesh``: DTensor's implicit
    replication, so that a plain tensor meeting a DTensor (a mask, a
    position index, a 0-d constant) is taken as replicated. Contexts
    nest (a train step around a loss around a backward). A null context
    without a mesh."""
    if mesh is None:
        return contextlib.nullcontext()
    return _replicating()


def tree_context(*trees: Any):
    """``mesh_context`` of the first DTensor leaf's mesh among ``trees``
    (an optimizer or gradient utility on sharded parameters), else a null
    context."""
    from torch.utils import _pytree as pytree

    for tree in trees:
        for leaf in pytree.tree_leaves(tree):
            if is_dtensor(leaf):
                return mesh_context(leaf.device_mesh)
    return contextlib.nullcontext()


def whole(x: Any) -> Any:
    """A DTensor gathered whole on every rank (a scalar reduction, a
    serving output); a plain tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


class Region:
    """Plain per-rank code over ``mesh`` (see the module docstring)."""

    def __init__(self, mesh: Any, split: Sequence[str] = ()):
        self.mesh = mesh
        self.names = tuple(mesh_shape(mesh))
        self.split = frozenset(split)
        unknown = self.split - set(self.names)
        if unknown:
            raise ValueError(
                f"region split over {sorted(unknown)}, which the mesh "
                f"{self.names} does not have")

    @classmethod
    def over(cls, mesh: Any, placements: Sequence[Any]) -> "Region":
        """A region whose work is divided over the mesh dims on which
        ``placements`` shard."""
        names = tuple(mesh_shape(mesh))
        return cls(mesh, [n for n, p in zip(names, placements)
                          if p.is_shard()])

    def coord(self, name: str) -> int:
        """This rank's coordinate on mesh dim ``name``."""
        return self.mesh.get_local_rank(name)

    def size(self, name: str) -> int:
        return mesh_shape(self.mesh)[name]

    def enter(self, x: Any, placements: Sequence[Any]) -> torch.Tensor:
        from torch.distributed.tensor import DTensor, Partial, Replicate

        placements = tuple(placements)
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, self.mesh,
                                   tuple(Replicate() for _ in self.names),
                                   run_check=False)
        if tuple(x.placements) != placements:
            x = x.redistribute(self.mesh, placements)
        grad = tuple(Partial() if n in self.split and not p.is_shard()
                     else p for n, p in zip(self.names, placements))
        return x.to_local(grad_placements=grad)

    def leave(self, t: torch.Tensor, placements: Sequence[Any]) -> Any:
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(t, self.mesh, tuple(placements),
                                  run_check=False)

    def reduce(self, t: torch.Tensor, placements: Sequence[Any]
               ) -> torch.Tensor:
        """The local ``t``, a ``Partial`` sum over the mesh dims where
        ``placements`` say so, summed there (an all-reduce, with autograd:
        each rank's part gets the sum's gradient)."""
        from torch.distributed.tensor import Replicate

        placements = tuple(placements)
        done = tuple(Replicate() if p.is_partial() else p
                     for p in placements)
        return self.leave(t, placements).redistribute(
            self.mesh, done).to_local()

    @torch.no_grad()
    def all_reduce(self, t: torch.Tensor, op: str, dim: str) -> torch.Tensor:
        """``t`` reduced in place over mesh dim ``dim`` (``op`` "max" or
        "sum"); no autograd (decode runs without it)."""
        import torch.distributed as dist

        red = {"max": dist.ReduceOp.MAX, "sum": dist.ReduceOp.SUM}[op]
        dist.all_reduce(t, op=red, group=self.mesh.get_group(dim))
        counts[f"all_reduce_{op}"] += 1
        return t


def block_offset(region: Region, placements: Sequence[Any], dim: int,
                 local_size: int) -> int:
    """The global index of this rank's first element along tensor dim
    ``dim``, split over the mesh dims whose placement is ``Shard(dim)``
    (the first of them major, as DTensor splits), ``local_size`` each."""
    block = 0
    for n, p in zip(region.names, placements):
        if p.is_shard(dim):
            block = block * region.size(n) + region.coord(n)
    return block * local_size



class SolveGroup:
    """The ranks over which one solve's state is split into blocks: a NODE
    block's residual stream on a mesh, each rank holding its batch block
    (``Region.enter``) and solving it on plain tensors. Every global
    reduction the solver makes goes through the group, so every rank
    takes the grid the whole state would take, trial for trial:

    * ``sum(t)`` — ``t`` summed over ``dims`` (the error norm's and the
      RMS norms' f32 partials); with autograd where ``t`` carries it
      (the naive method differentiates the norms): each rank's part gets
      the sum of every rank's gradient;
    * ``any(flag)`` / ``max(t)`` — a 0-d flag or value over ``dims``
      (the non-finite guard, the MALI lattice's scale, a status code);
    * ``numel(n)`` — the global count behind a local count ``n``.

    ``args_layout`` names, for each floating leaf of the solve's
    ``args`` (the block's parameters, local blocks), its share and its
    global size: the share is 1 over the number of ranks that hold the
    same block (1 where the leaf is split over every mesh dim). The
    adjoint's reverse state carries the parameters' cotangent ḡ beside
    the split state; ``weighted`` gives its group: over every mesh dim,
    with ``weights`` (one f32 tensor per dtype group of the raveled
    state: each element's share) and ``n_global`` the count of distinct
    elements. Each collective counts in ``counts``. On a one-rank group
    every reduction returns its input's value, so a one-rank solve is the
    mesh-less one's bit for bit."""

    def __init__(self, mesh: Any, dims: Sequence[str], weights=None,
                 n_global: int = 0, args_layout=None):
        self.mesh = mesh
        self.dims = tuple(dims)
        self.weights = weights
        self.n_global = n_global
        self.args_layout = args_layout
        sizes = mesh_shape(mesh)
        self.shards = 1
        for d in self.dims:
            self.shards *= sizes[d]

    def _groups(self):
        return [self.mesh.get_group(d) for d in self.dims]

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        if t.requires_grad:
            from torch.distributed.nn.functional import all_reduce

            for g in self._groups():
                t = all_reduce(t, op=dist.ReduceOp.SUM, group=g)
                counts["all_reduce_sum"] += 1
            return t
        t = t.detach().clone()
        for g in self._groups():
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=g)
            counts["all_reduce_sum"] += 1
        return t

    @torch.no_grad()
    def max(self, t: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        t = t.detach().clone()
        for g in self._groups():
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=g)
            counts["all_reduce_max"] += 1
        return t

    def any(self, flag: torch.Tensor) -> torch.Tensor:
        return self.max(flag.to(torch.int32)) > 0

    def numel(self, n: int) -> int:
        return self.n_global if self.weights is not None \
            else n * self.shards

    def sum_sq(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """The local sum of squares of dtype group ``i``'s f32 ``x``,
        weighted where the group carries weights."""
        if self.weights is None:
            return torch.sum(x * x)
        return torch.sum(x * x * self.weights[i])

    def state_share(self) -> float:
        """The share of an element of the split state in a sum over every
        mesh dim: the state is whole over the dims it is not split on."""
        return self.shards / self.mesh.size()

    def weighted(self, weights, n_global: int) -> "SolveGroup":
        """The group over every mesh dim with per-element ``weights``."""
        return SolveGroup(self.mesh, tuple(mesh_shape(self.mesh)), weights,
                          n_global)
