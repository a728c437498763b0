"""Logical-axis sharding rules over a torch ``DeviceMesh``.

Port of ``repro/distributed/sharding.py``. Tensors are annotated with
*logical* axis names ("batch", "embed", "mlp", "heads", ...), and a rule
table maps each logical name to zero or more mesh dimensions, so one
model definition runs on no mesh at all (every rule resolves to
``None``), on a ``(data, model)`` mesh and on a ``(pod, data, model)``
mesh, and a sharding decision changes in one place.

``DEFAULT_TRAIN_RULES`` shards weights 2-D (the ``embed`` dim over
``data``, head/mlp/vocab/expert dims over ``model``);
``DEFAULT_SERVE_RULES`` keeps the same weight layout and shards the
decode-time KV sequence over ``model``.

Torch has no ``PartitionSpec``: ``P`` is the port's (one entry per tensor
dim: a mesh-dim name, a tuple of names, or ``None``), and
``spec_to_placements`` turns one into DTensor placements. A mesh is a
``DeviceMesh`` (``mesh_dim_names``, ``shape``) over the default process
group's world, built by ``device_mesh``; asked for without a process
group, it raises ``NoProcessGroupError`` and never becomes a one-rank
group or the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple, Union

# A rule value is a mesh dimension name, a tuple of them, or None.
RuleValue = Union[None, str, Tuple[str, ...]]


class P(tuple):
    """A partition spec: ``P("data", None, ("pod", "data"))`` gives one
    entry per tensor dim, each a mesh-dim name, a tuple of names (the dim
    split over their product, the first name major) or ``None``
    (replicated). Immutable; equal when the entries are."""

    def __new__(cls, *parts: RuleValue) -> "P":
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}" if len(self) != 1 else \
            f"P({self[0]!r})"


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Immutable logical → mesh-dim mapping."""

    rules: Tuple[Tuple[str, RuleValue], ...]

    def get(self, logical: Optional[str]) -> RuleValue:
        if logical is None:
            return None
        for k, v in self.rules:
            if k == logical:
                return v
        raise KeyError(f"no sharding rule for logical axis {logical!r}")

    def override(self, **kw: RuleValue) -> "AxisRules":
        """A new rule set with some logical axes remapped."""
        d = dict(self.rules)
        d.update(kw)
        return AxisRules(tuple(d.items()))


# "batch" resolves to every data-parallel dim the mesh has: rule values
# are intersected with the mesh's dim names, so one table serves both the
# one-pod and the multi-pod mesh
_COMMON: Dict[str, RuleValue] = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,               # sequence dim of activations (unsharded)
    # residual-stream sequence dim: None = classic TP (activations
    # replicated over `model` between blocks); "model" = sequence
    # parallelism
    "res_seq": None,
    "embed_act": None,         # d_model dim of activations
    "heads_act": "model",      # per-head activation dim
    "kv_heads_act": None,      # kv heads are few: replicated
    "mlp_act": "model",
    "vocab_act": "model",
    "kv_seq": "model",         # decode-time KV cache sequence dim
    "expert_act": "model",
    # weights
    "embed": "data",           # d_model dim of weights  (FSDP)
    "heads": "model",          # q-head dim of weights   (TP)
    "kv_heads": None,
    "mlp": "model",            # d_ff dim of weights     (TP)
    "vocab": "model",          # vocab dim of embedding  (TP)
    "expert": "model",         # expert dim of MoE weights (EP)
    "layers": None,            # stacked-layer dim: replicated
    "conv": None,
    "stack": None,
}

DEFAULT_TRAIN_RULES = AxisRules(tuple(_COMMON.items()))
DEFAULT_SERVE_RULES = AxisRules(tuple(dict(_COMMON).items()))


def mesh_shape(mesh: Any) -> Dict[str, int]:
    """``{dim name: size}`` of a ``DeviceMesh``, in the mesh's dim
    order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    raise ValueError(
        "a mesh needs named dimensions: build it with init_device_mesh(..., "
        "mesh_dim_names=...) (repro_torch.launch.mesh, shard_mesh)")


def _filter_axes(value: RuleValue, mesh: Any) -> RuleValue:
    """Drop mesh dims the mesh does not have."""
    if value is None or mesh is None:
        return None if mesh is None else value
    names = set(mesh_shape(mesh))
    if isinstance(value, str):
        return value if value in names else None
    kept = tuple(a for a in value if a in names)
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


def logical_to_spec(logical_axes: Sequence[Optional[str]], rules: AxisRules,
                    mesh: Any = None) -> P:
    """The partition spec of a tensor annotated with logical axis names."""
    parts = []
    for ax in logical_axes:
        v = rules.get(ax)
        if mesh is not None:
            v = _filter_axes(v, mesh)
        parts.append(v)
    return P(*parts)


def fit_spec_to_shape(shape: Tuple[int, ...], spec: P, mesh: Any) -> P:
    """Drop mesh dims from tensor dims they do not divide.

    E.g. vocab=50280 over model=16 -> replicated; batch=1 over (pod,
    data) -> replicated. Dims are dropped right to left, so the leading
    (usually larger) one survives when a partial product fits.
    """
    sizes = mesh_shape(mesh)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, val in zip(shape, parts):
        if val is None:
            out.append(None)
            continue
        axes = list(val) if isinstance(val, tuple) else [val]
        while axes:
            prod = 1
            for a in axes:
                prod *= sizes[a]
            if dim % prod == 0:
                break
            axes.pop()          # drop the rightmost dim
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(tuple(axes))
    return P(*out)


def fit_specs(shapes: Any, specs: Any, mesh: Any) -> Any:
    """``fit_spec_to_shape`` leaf by leaf over matching trees of shapes
    (tensors, or anything with ``.shape``) and specs."""
    from torch.utils import _pytree as pytree

    return pytree.tree_map(
        lambda s, a: fit_spec_to_shape(tuple(a.shape), s, mesh), specs,
        shapes, is_leaf=lambda x: isinstance(x, P))


def spec_to_placements(spec: P, mesh: Any) -> tuple:
    """DTensor placements (one per mesh dim) of a partition spec: mesh dim
    m is ``Shard(d)`` when tensor dim d's entry names it, else
    ``Replicate()``. A tuple entry must list its mesh dims in the mesh's
    order, the order in which DTensor splits one tensor dim."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_shape(mesh))
    placements = [Replicate() for _ in names]
    seen = set()
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(
                    f"spec {spec!r} names mesh dim {a!r}, which the mesh "
                    f"{tuple(names)} does not have")
            if a in seen:
                raise ValueError(
                    f"spec {spec!r} shards over mesh dim {a!r} twice")
            seen.add(a)
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(
                f"spec entry {entry!r} lists mesh dims out of the mesh's "
                f"order {tuple(names)}: DTensor splits a tensor dim over "
                "its mesh dims in mesh order")
        for m in idx:
            placements[m] = Shard(d)
    return tuple(placements)


class NamedSharding(NamedTuple):
    """Where a tensor lives on a mesh: the mesh, the partition spec and
    its DTensor placements (torch's form of a named sharding)."""
    mesh: Any
    spec: P
    placements: tuple


def make_named_sharding(logical_axes: Sequence[Optional[str]],
                        rules: AxisRules, mesh: Any) -> NamedSharding:
    spec = logical_to_spec(logical_axes, rules, mesh)
    return NamedSharding(mesh, spec, spec_to_placements(spec, mesh))


def spec_tree_for(defs: Any, rules: AxisRules, mesh: Any) -> Any:
    """A tree of ParamDefs (anything with ``.logical``) mapped to partition
    specs."""
    from torch.utils import _pytree as pytree

    return pytree.tree_map(
        lambda d: logical_to_spec(d.logical, rules, mesh), defs,
        is_leaf=lambda d: hasattr(d, "logical"))


def placements_for(logical_axes: Sequence[Optional[str]], rules: AxisRules,
                   mesh: Any, shape: Sequence[int]) -> tuple:
    """The DTensor placements of a tensor of ``shape`` annotated with
    logical axes: the rule's spec with the mesh dims that do not divide
    their tensor dim dropped (``fit_spec_to_shape``), so a batch of 1 or a
    vocab of 50280 replicates instead of splitting unevenly."""
    spec = fit_spec_to_shape(tuple(shape),
                             logical_to_spec(logical_axes, rules, mesh), mesh)
    return spec_to_placements(spec, mesh)


def replicate(x: Any, mesh: Any) -> Any:
    """``x`` as a DTensor replicated over ``mesh``: a plain tensor is taken
    as the global value every rank holds (no communication); a DTensor is
    redistributed."""
    from torch.distributed.tensor import DTensor, Replicate

    full = tuple(Replicate() for _ in mesh_shape(mesh))
    if isinstance(x, DTensor):
        return x.redistribute(mesh, full)
    return DTensor.from_local(x, mesh, full, run_check=False)


def shard(x: Any, logical_axes: Sequence[Optional[str]], rules: AxisRules,
          mesh: Any) -> Any:
    """Place ``x`` by its logical axes: identity without a mesh; with one,
    ``redistribute`` to the rule's placements (``placements_for``). A
    plain tensor is taken as the global value every rank holds, so
    sharding it only slices (no communication)."""
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    pl = placements_for(logical_axes, rules, mesh, x.shape)
    if not isinstance(x, DTensor):
        x = replicate(x, mesh)
    if tuple(x.placements) == pl:
        return x
    return x.redistribute(mesh, pl)


def data_axis_names(mesh: Any) -> Tuple[str, ...]:
    """The mesh dims that carry data parallelism."""
    if mesh is None:
        return ()
    names = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def batch_partition_axes(mesh: Any,
                         rules: Optional[AxisRules] = None
                         ) -> Tuple[str, ...]:
    """The mesh dims the logical ``"batch"`` axis shards over: the rule
    table's ``"batch"`` entry (``("pod", "data")`` by default) intersected
    with the mesh's dim names; empty when the mesh has no data-parallel
    dim (e.g. a pure-TP mesh)."""
    rules = DEFAULT_TRAIN_RULES if rules is None else rules
    v = _filter_axes(rules.get("batch"), mesh)
    if v is None:
        return ()
    return (v,) if isinstance(v, str) else tuple(v)


def batch_shard_count(mesh: Any, rules: Optional[AxisRules] = None) -> int:
    """The number of batch shards ``odeint(..., mesh=...)`` splits into:
    the product of the mesh's batch-partition dim sizes (1 without a
    data dim or without a mesh)."""
    sizes = mesh_shape(mesh) if mesh is not None else {}
    n = 1
    for a in batch_partition_axes(mesh, rules):
        n *= sizes[a]
    return n


def model_axis_size(mesh: Any) -> int:
    if mesh is None:
        return 1
    return mesh_shape(mesh).get("model", 1)


class NoProcessGroupError(RuntimeError):
    """A mesh was asked for before ``torch.distributed`` was initialized."""


def world_size(what: str) -> int:
    """The default process group's size; ``what`` names the caller in the
    ``NoProcessGroupError`` raised without one."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        raise NoProcessGroupError(
            f"{what} needs a torch.distributed process group: call "
            "repro_torch.launch.mesh.init_distributed() (or "
            "torch.distributed.init_process_group) on every rank first")
    return dist.get_world_size()


def device_mesh(device_type: str, shape: Sequence[int],
                names: Sequence[str]):
    """``init_device_mesh(device_type, shape, mesh_dim_names=names)`` over
    the default group's world, which must hold exactly prod(shape)
    ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    world = world_size("a device mesh")
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(
            f"a mesh of shape {tuple(shape)} holds {n} ranks, but the "
            f"process group has {world}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def shard_mesh(device_type: str = "cuda"):
    """A flat 1-D ``("data",)`` mesh over the default process group's
    world: every rank a batch shard, no model parallelism. The simplest
    mesh ``odeint(..., mesh=...)`` takes. Raises without a process group
    (``repro_torch.launch.mesh.init_distributed``)."""
    return device_mesh(device_type, (world_size("shard_mesh"),), ("data",))
