"""Transformer block and its NODE form (the paper's ResNet → NODE step).

Port of ``repro/models/transformer.py``'s ``block_apply`` for kind
``"attn"`` without ``parallel_block``, and of ``_branch_fn``, the residual
branch that becomes the NODE dynamics. ``TransformerBlock``'s parameter
names are the reference's keys (``norm1.w``, ``mixer.wq``, …,
``ffn.w_out``), so ``convert.params_from_jax`` loads the reference's
weights directly. The rest of the stack (scan over layers, MoE, hybrid
and SSM kinds, caches) is slice G.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from repro_torch.core.integrate import SolveStats
from repro_torch.core.node_block import NodeConfig, node_block_solve
from repro_torch.device import resolve_device

from .attention import Attention
from .common import normal_init, rmsnorm
from .config import ModelConfig, RunConfig
from .ffn import FFN


class RMSNorm(nn.Module):
    """RMSNorm with the reference's parameter name ``w`` (init ones)."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.w = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.w, self.eps)


class TransformerBlock(nn.Module):
    """One pre-norm block: y = x + attn(n1(x)); out = y + ffn(n2(y)).

    f32 weights are drawn with numpy from ``seed`` at the reference's init
    scale (N(0, 1/fan_in), norms at one) on ``device`` (default the card;
    a missing card raises).
    """

    def __init__(self, cfg: ModelConfig, rcfg: RunConfig, *, seed: int = 0,
                 device="cuda"):
        super().__init__()
        if cfg.family != "dense" or cfg.norm != "rmsnorm" \
                or cfg.parallel_block:
            raise ValueError(
                f"only the dense pre-norm RMSNorm attention block is ported "
                f"(got family={cfg.family!r}, norm={cfg.norm!r}, "
                f"parallel_block={cfg.parallel_block}); the other kinds "
                "come with slice G (ROADMAP queue 1)")
        dev = resolve_device(device)
        self.cfg, self.rcfg = cfg, rcfg
        self.norm1 = RMSNorm(cfg.d_model, cfg.norm_eps)
        self.mixer = Attention(cfg)
        self.norm2 = RMSNorm(cfg.d_model, cfg.norm_eps)
        self.ffn = FFN(cfg, gated=(cfg.act == "silu"))
        rng = np.random.default_rng(seed)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith(".w") or name.split(".")[-1].startswith("b"):
                    continue        # norm weights stay one, biases zero
                p.copy_(normal_init(rng, tuple(p.shape)))
        self.to(device=dev)

    def forward(self, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``block_apply`` (train mode): (B,S,D) -> (B,S,D)."""
        rcfg = self.rcfg
        h = self.norm1(x)
        y = x + self.mixer(h, rcfg, mode="train", positions=positions)
        return y + self.ffn(self.norm2(y), rcfg)


def branch_fn(block: TransformerBlock, params: Dict[str, torch.Tensor],
              x: torch.Tensor,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The residual branch block(x) - x with ``params`` swapped in: the
    NODE dynamics f (``_branch_fn`` of the reference)."""
    return functional_call(block, params, (x,), {"positions": positions}) - x


def node_block(block: TransformerBlock, x: torch.Tensor,
               ncfg: Optional[NodeConfig] = None,
               positions: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, SolveStats]:
    """The block as an ODE block, z(1) = x + ∫₀¹ branch(z) dt, with ACA
    gradients for x and every parameter; returns (z(1), stats). ``ncfg``
    defaults to the block's ``RunConfig.node``.

    With ``ncfg.batch_axis=0`` every sample x[b] (S, D) is its own ODE on
    its own adaptive grid: the per-sample field runs the block on a batch
    of one, and ``stats`` fields are (B,).
    """
    ncfg = block.rcfg.node if ncfg is None else ncfg
    params = dict(block.named_parameters())
    if ncfg.batch_axis is None:
        def fn(p, z, t):
            return branch_fn(block, p, z, positions)
    elif ncfg.batch_axis in (0, -x.dim()):
        def fn(p, z, t):
            return branch_fn(block, p, z.unsqueeze(0), positions)[0]
    else:
        raise ValueError(
            f"node_block batches over the block's batch axis 0; got "
            f"batch_axis={ncfg.batch_axis}")
    return node_block_solve(fn, params, x, ncfg)


def full_buffer(ncfg: NodeConfig) -> NodeConfig:
    """``ncfg`` with the full checkpoint buffer (segmented ACA, which the
    reference's ``checkpoint_segments="auto"`` asks for, is slice D; its
    gradients are the same)."""
    return dataclasses.replace(ncfg, checkpoint_segments=None)
