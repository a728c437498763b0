"""Shared model building blocks of the port: norm, RoPE, dense, activation.

Port of ``repro/models/common.py``'s functions on tensors. Weights keep
the reference's ``(in, out)`` layout, so ``x @ w`` is the same product on
both sides. ``normal_init`` reproduces the reference's init *scale*
(std 1/sqrt(fan_in)) from a numpy seed; the numbers themselves differ
from ``jax.random``'s.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with f32 statistics, cast back to x's dtype."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(dt)


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
    fan_in = shape[0] if len(shape) == 1 else int(math.prod(shape[:-1]))
    w = rng.standard_normal(shape, dtype=np.float32) / math.sqrt(
        max(fan_in, 1))
    return torch.from_numpy(w.astype(np.float32))
