"""Shared model building blocks of the port: ParamDef trees, norms, RoPE,
dense, activation, initializers.

Port of ``repro/models/common.py``'s functions on tensors. Weights keep
the reference's ``(in, out)`` layout, so ``x @ w`` is the same product on
both sides. A parameter tree is nested dicts of tensors with the
reference's keys; ``ParamDef`` describes one leaf (shape, dtype, init) and
``init_params`` draws a tree of them at the reference's init *scales*
(``_init_one``) from a ``torch.Generator``. ``normal_init`` draws one
N(0, 1/fan_in) weight from a numpy seed. The numbers of either differ from
``jax.random``'s; tests carry the reference's own weights over with
``convert.tree_from_jax``.

``ParamDef.logical`` names each dim's logical sharding axis, as in the
reference: ``abstract_params`` gives meta-tensor stand-ins (no memory),
``param_specs`` (``distributed.sharding.spec_tree_for``) the partition
specs under a rule table, and ``place_params`` / ``placer`` the DTensors
of a mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# the reference's name for a ParamDef tree's partition specs
from repro_torch.distributed.sharding import spec_tree_for as param_specs


Tree = Any


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """One parameter (or cache) leaf: shape, dtype, *logical* sharding
    axes (one name or ``None`` per dim, mapped to mesh dims by
    ``AxisRules``; left out, every dim is replicated) and initializer
    (``normal`` with std ``scale`` or 1/sqrt(fan_in), ``embed`` with std
    ``scale`` or 0.02, ``zeros``, ``ones``, ``uniform_ssm``: log U[1, 16],
    the SSM decay rates A stored as log)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    logical: Optional[Tuple[Optional[str], ...]] = None
    init: str = "normal"
    scale: Optional[float] = None

    def __post_init__(self):
        if self.logical is None:
            object.__setattr__(self, "logical", (None,) * len(self.shape))
        elif len(self.shape) != len(self.logical):
            raise ValueError(
                f"ParamDef: shape {self.shape} and logical axes "
                f"{self.logical} have different ranks")


def _is_def(x) -> bool:
    return isinstance(x, ParamDef)


def _fan_in(shape: Tuple[int, ...]) -> int:
    # weights are stored (in_dim..., out_dim); fan-in = prod of all but last
    if len(shape) == 1:
        return shape[0]
    return int(math.prod(shape[:-1]))


def map_defs(fn, defs: Tree) -> Tree:
    """Apply ``fn`` to every ParamDef leaf of a nested dict, in order."""
    if _is_def(defs):
        return fn(defs)
    return {k: map_defs(fn, v) for k, v in defs.items()}


def _init_one(d: ParamDef, gen: torch.Generator,
              device: torch.device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    if d.init == "uniform_ssm":
        u = torch.rand(d.shape, generator=gen, dtype=torch.float32,
                       device=device)
        return torch.log(1.0 + 15.0 * u).to(d.dtype)
    if d.init == "embed":
        std = d.scale if d.scale is not None else 0.02
    elif d.init == "normal":
        std = d.scale if d.scale is not None else 1.0 / math.sqrt(
            max(_fan_in(d.shape), 1))
    else:
        raise ValueError(f"unknown init {d.init!r}")
    w = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                    device=device)
    # in place: one f32 temporary a leaf (deepseek_moe_16b's stacked expert
    # weights draw 5.2 G values), then the cast to the leaf's dtype
    return w.mul_(std).to(d.dtype)


def init_params(defs: Tree, gen: torch.Generator, device,
                place=None) -> Tree:
    """Materialize a ParamDef tree on ``device`` (the generator's device),
    drawing the leaves one after another from ``gen``. ``place(d, t)``,
    when given, turns each leaf into what the tree keeps as soon as it is
    drawn (``placer``: its DTensor shard), so at most one whole leaf
    exists at a time."""
    dev = torch.device(device)
    if place is None:
        return map_defs(lambda d: _init_one(d, gen, dev), defs)
    return map_defs(lambda d: place(d, _init_one(d, gen, dev)), defs)


def abstract_params(defs: Tree) -> Tree:
    """Shape and dtype stand-ins of a ParamDef tree: tensors on the
    ``meta`` device, which allocate nothing."""
    return map_defs(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                          device="meta"), defs)


def placer(rules, mesh):
    """``place(d, t)``: the whole leaf ``t`` of ParamDef ``d`` as a
    DTensor on ``mesh``, placed by ``d.logical`` under ``rules``
    (``sharding.placements_for``). Each rank keeps a copy of its own
    block only; on a one-rank mesh the tensor is wrapped as it is, with no
    copy."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import (mesh_shape,
                                                  placements_for, replicate)

    one = math.prod(mesh_shape(mesh).values()) == 1

    def place(d: ParamDef, t: torch.Tensor):
        pl = placements_for(d.logical, rules, mesh, d.shape)
        if one:
            return DTensor.from_local(t, mesh, pl, run_check=False)
        block = replicate(t, mesh).redistribute(mesh, pl).to_local()
        return DTensor.from_local(block.clone(), mesh, pl, run_check=False)

    return place


def place_params(tree: Tree, defs: Tree, rules, mesh) -> Tree:
    """A tree of whole tensors (``tree``, ``defs``'s nesting) placed on
    ``mesh`` leaf by leaf (``placer``); the tree itself without a mesh."""
    if mesh is None:
        return tree
    place = placer(rules, mesh)

    def walk(d, t):
        if _is_def(d):
            return place(d, t)
        return {k: walk(d[k], t[k]) for k in t}   # the tree's key order

    return walk(defs, tree)


def param_count(defs: Tree) -> int:
    n = 0

    def count(d: ParamDef):
        nonlocal n
        n += int(math.prod(d.shape))
        return d

    map_defs(count, defs)
    return n


# ----------------------------------------------------------------------------
# Norms
# ----------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with f32 statistics, cast back to x's dtype."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(dt)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(dt)


def apply_norm(kind: str, x: torch.Tensor, p: Dict[str, torch.Tensor],
               eps: float = 1e-6, kernel: bool = False) -> torch.Tensor:
    """The block's norm. ``kernel`` sends RMSNorm through K7 (the serving
    modes under ``use_pallas``); LayerNorm has no kernel."""
    if kind == "rmsnorm":
        if kernel:
            return kernel_rmsnorm(x, p["w"], eps)
        return rmsnorm(x, p["w"], eps)
    if kind == "layernorm":
        return layernorm(x, p["w"], p["b"], eps)
    raise ValueError(kind)


def kernel_rmsnorm(x: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm through K7 (``kernels.ops.rmsnorm``). A DTensor runs on each
    rank's local rows, with the normalized (last) dim made whole first
    (an all-gather where it is sharded, as Mamba-2's gated norm over the
    model-sharded inner dim is) and the weight replicated."""
    from repro_torch.distributed.regions import Region, is_dtensor
    from repro_torch.kernels import ops

    if not is_dtensor(x):
        return ops.rmsnorm(x, weight, eps)
    from torch.distributed.tensor import Replicate

    last = x.ndim - 1
    pl = tuple(Replicate() if p.is_partial() or p.is_shard(last) else p
               for p in x.placements)
    r = Region.over(x.device_mesh, pl)
    y = ops.rmsnorm(r.enter(x, pl),
                    r.enter(weight, tuple(Replicate() for _ in pl)), eps)
    return r.leave(y, pl)


def norm_defs(kind: str, dim: int, dtype: torch.dtype) -> Tree:
    if kind == "rmsnorm":
        return {"w": ParamDef((dim,), dtype, ("embed_act",), init="ones")}
    if kind == "layernorm":
        return {"w": ParamDef((dim,), dtype, ("embed_act",), init="ones"),
                "b": ParamDef((dim,), dtype, ("embed_act",), init="zeros")}
    raise ValueError(kind)


# ----------------------------------------------------------------------------
# Rotary position embeddings, dense, activation
# ----------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    """Inverse frequencies (head_dim/2,), f32."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate (..., S, H, Dh) by positions (..., S); NeoX-style half-split."""
    dh = x.shape[-1]
    inv = rope_freqs(dh, theta, device=x.device)           # (dh/2,)
    ang = positions.float()[..., None] * inv                # (..., S, dh/2)
    cos = torch.cos(ang)[..., None, :]                      # (..., S, 1, dh/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
          compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """x @ w (+ b) with the operands cast to the compute dtype."""
    y = torch.matmul(x.to(compute_dtype), w.to(compute_dtype))
    if b is not None:
        y = y + b.to(compute_dtype)
    return y


def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu(x)
    raise ValueError(name)


def normal_init(rng: np.random.Generator,
                shape: Tuple[int, ...]) -> torch.Tensor:
    """N(0, 1/fan_in) f32 weights on the CPU, fan-in = prod(shape[:-1]) as
    in the reference's ``ParamDef(init="normal")``; drawn with numpy."""
    w = rng.standard_normal(shape, dtype=np.float32) / math.sqrt(
        max(_fan_in(shape), 1))
    return torch.from_numpy(w.astype(np.float32))
