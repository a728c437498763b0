"""Gradient utilities: clipping, compression with error feedback.

Port of ``repro/optim/grad_utils.py``. Compression reduces the
data-parallel all-reduce volume; on one card the compress -> decompress
round trip and its error-feedback state are what run:

* ``int8_compress_decompress`` — per-tensor symmetric int8 quantization,
  the residual carried to the next step;
* ``topk_sparsify`` — keep the top fraction by magnitude, the rest
  accumulates in the error buffer.

Every function works on pytrees (dicts, lists, tuples) of tensors and
reads nothing back to the host. On DTensors (a mesh) every reduction is
over the whole tensor, not the rank's block: the global norm and the
int8 scale are reduced across the mesh, and the top-k threshold is the
k-th largest of the union of every block's own top k (exact: the global
top k lie within it).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.distributed.regions import is_dtensor, tree_context, whole

PyTree = Any


def global_norm(tree: PyTree) -> torch.Tensor:
    leaves = pytree.tree_leaves(tree)
    total = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    with tree_context(tree):
        for leaf in leaves:
            total = total + whole(torch.sum(leaf.float() ** 2))
    return torch.sqrt(total)


def clip_by_global_norm(grads: PyTree, max_norm: float,
                        on_nonfinite: str = "zero"
                        ) -> Tuple[PyTree, torch.Tensor]:
    """Scale ``grads`` so their global norm is at most ``max_norm``.

    Returns (clipped grads, raw global norm). A non-finite norm (one Inf
    or NaN leaf poisons the whole reduction) would scale every leaf to
    NaN; ``on_nonfinite`` picks the recovery instead: ``"zero"`` (default)
    returns all-zero gradients, ``"keep"`` the grads unclipped. Either way
    the raw norm is returned, so the train step's skip guard sees the
    failure and counts it."""
    if on_nonfinite not in ("zero", "keep"):
        raise ValueError(
            f"on_nonfinite must be 'zero' or 'keep'; got {on_nonfinite!r}")
    norm = global_norm(grads)
    finite = torch.isfinite(norm)
    safe_norm = torch.where(finite, norm, torch.ones_like(norm))
    scale = torch.clamp(max_norm / torch.clamp(safe_norm, min=1e-12),
                        max=1.0)

    def clip(g):
        gc = (g.float() * scale).to(g.dtype)
        if on_nonfinite == "zero":
            # a select against finite: Inf * 0 = NaN, so the bad branch
            # is never multiplied
            return torch.where(finite, gc, torch.zeros_like(gc))
        return torch.where(finite, gc, g)

    with tree_context(grads):
        return pytree.tree_map(clip, grads), norm


class CompressionState(NamedTuple):
    error: PyTree          # error-feedback residual, f32


def init_compression_state(grads: PyTree) -> CompressionState:
    return CompressionState(error=pytree.tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads))


def _map_pairs(fn, grads: PyTree, error: PyTree
               ) -> Tuple[PyTree, CompressionState]:
    g_leaves, spec = pytree.tree_flatten(grads)
    pairs = [fn(g, e) for g, e in zip(g_leaves, pytree.tree_leaves(error))]
    return (pytree.tree_unflatten([x[0] for x in pairs], spec),
            CompressionState(error=pytree.tree_unflatten(
                [x[1] for x in pairs], spec)))


def int8_compress_decompress(grads: PyTree,
                             state: Optional[CompressionState] = None
                             ) -> Tuple[PyTree, CompressionState]:
    """Symmetric per-tensor int8 quantize -> dequantize with error
    feedback. Returns (decompressed grads, new state); the int8 payload
    and the f32 scale are what would cross the network."""
    if state is None:
        state = init_compression_state(grads)

    def comp(g, e):
        gf = g.float() + e
        scale = torch.clamp(whole(gf.abs().max()), min=1e-12) / 127.0
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        deq = q.float() * scale
        return deq.to(g.dtype), gf - deq

    with tree_context(grads):
        return _map_pairs(comp, grads, state.error)


def topk_sparsify(grads: PyTree, frac: float,
                  state: Optional[CompressionState] = None
                  ) -> Tuple[PyTree, CompressionState]:
    """Keep the top ``frac`` of the entries of each tensor (by |value|);
    the rest accumulates in the error buffer."""
    if state is None:
        state = init_compression_state(grads)

    def comp(g, e):
        gf = g.float() + e
        k = max(int(gf.numel() * frac), 1)
        thresh = _kth_largest(gf.abs(), k)
        kept = torch.where(gf.abs() >= thresh, gf, torch.zeros_like(gf))
        return kept.to(g.dtype), gf - kept

    with tree_context(grads):
        return _map_pairs(comp, grads, state.error)


def _kth_largest(a: torch.Tensor, k: int) -> torch.Tensor:
    """The k-th largest entry of ``a`` (0-d). A DTensor's comes from the
    blocks' own top k gathered over the mesh dims that split it (a block
    replicated over a dim is taken once)."""
    if not is_dtensor(a):
        return torch.topk(a.reshape(-1), k).values[-1]
    from torch.distributed.tensor import DTensor, Replicate, Shard

    block = a.to_local().reshape(-1)
    cand = torch.topk(block, min(k, block.numel())).values
    pl = tuple(Shard(0) if p.is_shard() else Replicate()
               for p in a.placements)
    union = DTensor.from_local(cand, a.device_mesh, pl,
                               run_check=False).full_tensor()
    return torch.topk(union, k).values[-1]
