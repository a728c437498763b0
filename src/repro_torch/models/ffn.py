"""Feed-forward block: SwiGLU (gated) or plain MLP, with bias variants.

Port of ``repro/models/ffn.py``; parameter names are the reference's keys
(``w_in``, ``w_gate``, ``w_out``, ``b_in``, ``b_out``).
"""

from __future__ import annotations

import torch
from torch import nn

from .common import activation, dense
from .config import ModelConfig, RunConfig


class FFN(nn.Module):
    """x (B,S,D) -> (B,S,D); SwiGLU when gated."""

    def __init__(self, cfg: ModelConfig, d_ff: int = 0, gated: bool = True):
        super().__init__()
        d, f = cfg.d_model, d_ff or cfg.d_ff
        self.act = cfg.act
        self.w_in = nn.Parameter(torch.empty(d, f))
        self.w_out = nn.Parameter(torch.empty(f, d))
        self.w_gate = nn.Parameter(torch.empty(d, f)) if gated else None
        self.b_in = nn.Parameter(torch.zeros(f)) if cfg.mlp_bias else None
        self.b_out = nn.Parameter(torch.zeros(d)) if cfg.mlp_bias else None

    def forward(self, x: torch.Tensor, rcfg: RunConfig) -> torch.Tensor:
        cd = rcfg.compute_dtype
        h = dense(x, self.w_in, self.b_in, cd)
        if self.w_gate is not None:
            g = dense(x, self.w_gate, None, cd)
            h = activation(self.act, g) * h
        else:
            h = activation(self.act, h)
        return dense(h, self.w_out, self.b_out, cd)
