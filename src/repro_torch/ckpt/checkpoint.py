"""Atomic, resumable checkpointing of pytrees of tensors.

Port of ``repro/ckpt/checkpoint.py``, the same contract:

* **Atomicity** — a step is written to ``step_XXXXXXXXXX.tmp/`` and
  ``os.rename``d to ``step_XXXXXXXXXX/`` only after every leaf and the
  manifest are on disk and fsync'd, so a crash mid-write never leaves a
  half-readable latest step.
* **Auto-resume** — ``latest_step`` finds the highest committed step;
  ``restore_checkpoint`` validates the manifest (tree structure hash,
  every leaf present, shapes) and falls back to the previous committed
  step when validation fails.
* **keep-k GC** — older committed steps beyond ``keep`` are removed only
  after a newer one commits.

Every leaf is its own ``.npy`` file keyed by its tree path. numpy has no
bf16, so a bf16 leaf is stored as its uint16 bits and the manifest keeps
the tensor's dtype: a round trip is bitwise for every dtype. A restored
leaf lands on the device of the corresponding leaf of ``like``.

A tree of DTensors (parameters and optimizer moments on a mesh) is saved
whole: every rank gathers each leaf (``full_tensor``, one leaf at a time)
and global rank 0 writes, the others waiting at a barrier. A restored
leaf takes the placements of its ``like`` leaf (each rank keeps its own
block), so a run saved on a mesh resumes without one, and the other way
round.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

PyTree = Any

_MANIFEST = "manifest.json"
# dtypes numpy cannot hold, stored as the bits of an integer of their width
_AS_BITS = {torch.bfloat16: torch.int16}
_DTYPES = {str(d)[6:]: d for d in (
    torch.float64, torch.float32, torch.float16, torch.bfloat16,
    torch.int64, torch.int32, torch.int16, torch.int8, torch.uint8,
    torch.bool)}


def _leaf_key(path) -> str:
    out = []
    for p in path:
        for attr in ("key", "idx", "name"):
            if hasattr(p, attr):
                out.append(str(getattr(p, attr)))
                break
        else:
            out.append(str(p))
    return "__".join(out) or "leaf"


def _treedef_hash(tree: PyTree) -> str:
    s = str(pytree.tree_structure(tree))
    return hashlib.sha256(s.encode()).hexdigest()[:16]


def _dtensor(x) -> bool:
    return type(x).__name__ == "DTensor"


def _sharded(tree: PyTree) -> bool:
    return any(_dtensor(x) for x in pytree.tree_leaves(tree))


def _writer(tree: PyTree) -> bool:
    """Whether this process writes ``tree``: always, unless the tree holds
    DTensors, which global rank 0 alone writes."""
    if not _sharded(tree):
        return True
    import torch.distributed as dist

    return dist.get_rank() == 0


def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    t = leaf.detach()
    if _dtensor(t):
        t = t.full_tensor()
    if t.dtype in _AS_BITS:
        t = t.view(_AS_BITS[t.dtype])
    return t.cpu().numpy()


def _write(path: str, write) -> None:
    with open(path, "wb" if not path.endswith(".json") else "w") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())


def save_checkpoint(directory: str, step: int, tree: PyTree) -> str:
    """Atomic write of ``tree`` for ``step``. Returns the final path.
    DTensor leaves are gathered whole on every rank; rank 0 writes."""
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    writer = _writer(tree)
    if writer:
        os.makedirs(directory, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)

    leaves = pytree.tree_flatten_with_path(tree)[0]
    manifest = {"step": step, "treedef": _treedef_hash(tree), "leaves": {}}
    for path, leaf in leaves:
        key = _leaf_key(path)
        leaf = torch.as_tensor(leaf)
        arr = _to_numpy(leaf)
        fname = key + ".npy"
        if writer:
            _write(os.path.join(tmp, fname), lambda f: np.save(f, arr))
        manifest["leaves"][key] = {
            "file": fname, "shape": list(leaf.shape),
            "dtype": str(leaf.dtype)[6:]}
    if writer:
        _write(os.path.join(tmp, _MANIFEST),
               lambda f: json.dump(manifest, f))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)    # the commit point
    if _sharded(tree):
        import torch.distributed as dist

        dist.barrier()
    return final


def _committed_steps(directory: str):
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, _MANIFEST)):
                try:
                    steps.append(int(name[5:]))
                except ValueError:
                    continue
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    steps = _committed_steps(directory)
    return steps[-1] if steps else None


def _validate_and_load(path: str, like: PyTree) -> PyTree:
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    if manifest["treedef"] != _treedef_hash(like):
        raise ValueError(f"{path}: tree structure mismatch")
    leaves, spec = pytree.tree_flatten_with_path(like)
    out = []
    for lpath, leaf in leaves:
        key = _leaf_key(lpath)
        meta = manifest["leaves"].get(key)
        if meta is None:
            raise ValueError(f"{path}: missing leaf {key}")
        leaf = torch.as_tensor(leaf)
        if tuple(meta["shape"]) != tuple(leaf.shape):
            raise ValueError(
                f"{path}: leaf {key} shape {tuple(meta['shape'])} != "
                f"{tuple(leaf.shape)}")
        t = torch.from_numpy(np.load(os.path.join(path, meta["file"])))
        dtype = _DTYPES[meta["dtype"]]
        if dtype in _AS_BITS:
            t = t.view(dtype)
        out.append(_like(t.reshape(leaf.shape), leaf))
    return pytree.tree_unflatten(out, spec)


def _like(t: torch.Tensor, leaf) -> torch.Tensor:
    """The whole tensor ``t`` on ``leaf``'s device, and with its placements
    when ``leaf`` is a DTensor (this rank's block)."""
    if not _dtensor(leaf):
        return t.to(leaf.device)
    from torch.distributed.tensor import DTensor, Replicate

    mesh = leaf.device_mesh
    whole = DTensor.from_local(t.to(leaf.device), mesh,
                               tuple(Replicate() for _ in leaf.placements),
                               run_check=False)
    block = whole.redistribute(mesh, leaf.placements).to_local()
    return DTensor.from_local(block.clone(), mesh, leaf.placements,
                              run_check=False)


def restore_checkpoint(directory: str, like: PyTree,
                       step: Optional[int] = None) -> Optional[tuple]:
    """Restore the given (or latest valid) step: (step, tree) or None. A
    corrupt newest checkpoint falls back to the previous one."""
    steps = _committed_steps(directory)
    if step is not None:
        steps = [s for s in steps if s == step]
    for s in reversed(steps):
        path = os.path.join(directory, f"step_{s:010d}")
        try:
            return s, _validate_and_load(path, like)
        except (OSError, ValueError, KeyError):
            continue    # corrupt or partial: try the previous step
    return None


class CheckpointManager:
    """save/restore with keep-k garbage collection."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep

    def save(self, step: int, tree: PyTree) -> str:
        path = save_checkpoint(self.directory, step, tree)
        if _writer(tree):
            self._gc()
        return path

    def restore(self, like: PyTree, step: Optional[int] = None):
        return restore_checkpoint(self.directory, like, step)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def _gc(self):
        steps = _committed_steps(self.directory)
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"),
                          ignore_errors=True)
