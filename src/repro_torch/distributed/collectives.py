"""The collectives of a sharded batched solve, and their counts.

``odeint(..., batch_axis=0, mesh=...)`` runs in torch's process-per-rank
form: every rank calls it with the same global inputs and gets the global
result. ``BatchShard`` is one rank's view of the batch: its contiguous
block of rows, the process group of the mesh's batch dims (ranks that
differ only in other dims, e.g. ``model``, solve the same rows) and the
three autograd-aware moves around the shard-local solve:

* ``take`` — this rank's rows of every ``z0`` leaf; backward gathers the
  row cotangents, so every rank's ``z0.grad`` is whole (one all_gather);
* ``replicate`` — ``args`` as they are; backward sums their cotangents
  over the batch group (one all_reduce);
* ``gather`` — the rows of every ``ys`` leaf from every rank (one
  all_gather); backward takes this rank's rows of the cotangent.

So a solve's forward runs two collectives (``ys`` and the stats) and its
backward two (the ``args`` sum and the ``z0`` gather), all outside the
trial loops. Leaves travel as their bytes, packed row by row into one
buffer, so leaves of several dtypes (bf16 among them) move exactly in one
collective on gloo and on NCCL. ``counts`` counts the collectives issued
(``reset_counts`` zeroes it).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

counts: Dict[str, int] = {"all_gather": 0, "all_reduce": 0}


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0


def _batch_group(mesh, axes: Sequence[str]):
    """The process group over the mesh dims ``axes`` that holds this rank
    (the dims flattened, the first major)."""
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[tuple(axes)]._flatten().get_group()


def _block_of(mesh, axes: Sequence[str], coord: Sequence[int]) -> int:
    """The row block of the rank at mesh coordinate ``coord``: its
    coordinates on ``axes``, row-major (the first dim major)."""
    names = list(mesh.mesh_dim_names)
    block = 0
    for a in axes:
        d = names.index(a)
        block = block * mesh.size(d) + int(coord[d])
    return block


class BatchShard:
    """One rank's block of a (B, ...) batch over the mesh dims ``axes``
    (``B`` divides evenly over them; the caller checks)."""

    def __init__(self, mesh, axes: Sequence[str], batch: int):
        self.group = _batch_group(mesh, axes)
        self.n = dist.get_world_size(self.group)
        self.rows = batch // self.n
        self.block = _block_of(mesh, axes, mesh.get_coordinate())
        self.lo = self.block * self.rows
        # gather order: group rank j holds row block order[j]
        grid = mesh.mesh
        order = []
        for r in dist.get_process_group_ranks(self.group):
            coord = (grid == r).nonzero()[0].tolist()
            order.append(_block_of(mesh, axes, coord))
        self.order = order

    # -- raw collectives (counted) --------------------------------------

    def gather_rows(self, tensors: List[torch.Tensor],
                    dim: int = 0) -> List[torch.Tensor]:
        """Every rank's rows (along ``dim``) of each tensor, in block
        order: one all_gather of the tensors' bytes, packed row by row."""
        rows = [t.movedim(dim, 0).contiguous() for t in tensors]
        flat = [r.reshape(self.rows, -1) for r in rows]
        packed = torch.cat([f.view(torch.uint8) for f in flat], dim=1)
        parts = [torch.empty_like(packed) for _ in range(self.n)]
        counts["all_gather"] += 1
        dist.all_gather(parts, packed, group=self.group)
        ordered = [None] * self.n
        for j, p in enumerate(parts):
            ordered[self.order[j]] = p
        full = torch.cat(ordered, dim=0)
        out, col = [], 0
        for r, f in zip(rows, flat):
            width = f.shape[1] * f.element_size()
            piece = full[:, col:col + width].contiguous().view(f.dtype)
            col += width
            out.append(piece.reshape((self.rows * self.n,)
                                     + tuple(r.shape[1:])).movedim(0, dim))
        return out

    def all_reduce_sum(self, tensors: List[torch.Tensor]
                       ) -> List[torch.Tensor]:
        """Each tensor summed over the batch group: one all_reduce of them
        all, in their promoted dtype (bf16 and f16 in f32), each rounded
        back to its own dtype once."""
        wide = torch.float32
        for t in tensors:
            wide = torch.promote_types(wide, t.dtype)
        buf = torch.cat([t.reshape(-1).to(wide) for t in tensors])
        counts["all_reduce"] += 1
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        out, off = [], 0
        for t in tensors:
            out.append(buf[off:off + t.numel()].reshape(t.shape).to(t.dtype))
            off += t.numel()
        return out

    # -- autograd-aware moves --------------------------------------------

    def take(self, tree: Any) -> Any:
        """This rank's rows of every leaf (batch at dim 0)."""
        leaves, spec = pytree.tree_flatten(tree)
        return pytree.tree_unflatten(list(_TakeRows.apply(self, *leaves)),
                                     spec)

    def gather(self, tree: Any, dim: int = 1) -> Any:
        """Every rank's rows (along ``dim``) of every leaf."""
        leaves, spec = pytree.tree_flatten(tree)
        return pytree.tree_unflatten(
            list(_GatherRows.apply(self, dim, *leaves)), spec)

    def replicate(self, args: Any) -> Any:
        """``args`` unchanged; the cotangents of its tensors that require
        grad are summed over the batch group in the backward."""
        leaves, spec = pytree.tree_flatten(args)
        idx = [i for i, x in enumerate(leaves)
               if isinstance(x, torch.Tensor) and x.requires_grad]
        if idx:
            outs = _ReplicatedArgs.apply(self, *(leaves[i] for i in idx))
            for i, o in zip(idx, outs):
                leaves[i] = o
        return pytree.tree_unflatten(leaves, spec)


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard: BatchShard, *leaves):
        ctx.shard = shard
        return tuple(x.narrow(0, shard.lo, shard.rows).clone()
                     for x in leaves)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.shard.gather_rows(list(grads), 0))


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard: BatchShard, dim: int, *leaves):
        ctx.shard, ctx.dim = shard, dim
        return tuple(shard.gather_rows(list(leaves), dim))

    @staticmethod
    def backward(ctx, *grads):
        s = ctx.shard
        return (None, None, *(g.narrow(ctx.dim, s.lo, s.rows).contiguous()
                              for g in grads))


class _ReplicatedArgs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, shard: BatchShard, *tensors):
        ctx.shard = shard
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.shard.all_reduce_sum(list(grads)))
