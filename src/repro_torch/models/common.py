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
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


Tree = Any


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """One parameter (or cache) leaf: shape, dtype and initializer
    (``normal`` with std ``scale`` or 1/sqrt(fan_in), ``embed`` with std
    ``scale`` or 0.02, ``zeros``, ``ones``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    init: str = "normal"
    scale: Optional[float] = None


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
    if d.init == "embed":
        std = d.scale if d.scale is not None else 0.02
    elif d.init == "normal":
        std = d.scale if d.scale is not None else 1.0 / math.sqrt(
            max(_fan_in(d.shape), 1))
    else:
        raise ValueError(f"unknown init {d.init!r}")
    w = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (w * std).to(d.dtype)


def init_params(defs: Tree, gen: torch.Generator, device) -> Tree:
    """Materialize a ParamDef tree on ``device`` (the generator's device),
    drawing the leaves one after another from ``gen``."""
    dev = torch.device(device)
    return map_defs(lambda d: _init_one(d, gen, dev), defs)


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
            from repro_torch.kernels import ops
            return ops.rmsnorm(x, p["w"], eps)
        return rmsnorm(x, p["w"], eps)
    if kind == "layernorm":
        return layernorm(x, p["w"], p["b"], eps)
    raise ValueError(kind)


def norm_defs(kind: str, dim: int, dtype: torch.dtype) -> Tree:
    if kind == "rmsnorm":
        return {"w": ParamDef((dim,), dtype, init="ones")}
    if kind == "layernorm":
        return {"w": ParamDef((dim,), dtype, init="ones"),
                "b": ParamDef((dim,), dtype, init="zeros")}
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
