"""Feed-forward blocks: SwiGLU (gated) and plain MLP, with bias variants.

Port of ``repro/models/ffn.py``; parameter names are the reference's keys
(``w_in``, ``w_gate``, ``w_out``, ``b_in``, ``b_out``). The block is
``gated`` when ``cfg.act == "silu"`` (the caller decides, as the
reference's ``block_defs`` does), so a GeLU MLP such as RecurrentGemma's
has no gate. On a mesh the hidden activations are placed over ``model``
(``mlp_act``) and the output back on the residual stream's placement, as
the reference annotates them.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.distributed.sharding import shard

from .common import ParamDef, Tree, activation, dense
from .config import ModelConfig, RunConfig


def ffn_defs(cfg: ModelConfig, param_dtype: torch.dtype, d_ff: int = 0,
             gated: bool = True) -> Tree:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    defs = {"w_in": ParamDef((d, f), param_dtype, ("embed", "mlp")),
            "w_out": ParamDef((f, d), param_dtype, ("mlp", "embed"))}
    if gated:
        defs["w_gate"] = ParamDef((d, f), param_dtype, ("embed", "mlp"))
    if cfg.mlp_bias:
        defs["b_in"] = ParamDef((f,), param_dtype, ("mlp_act",),
                                init="zeros")
        defs["b_out"] = ParamDef((d,), param_dtype, ("embed_act",),
                                 init="zeros")
    return defs


def ffn_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
              rcfg: RunConfig) -> torch.Tensor:
    """x (B,S,D) -> (B,S,D). SwiGLU when a gate weight is present."""
    cd = rcfg.compute_dtype
    mesh, rules = rcfg.mesh, rcfg.rules
    h = dense(x, p["w_in"], p.get("b_in"), cd)
    h = shard(h, ("batch", "seq", "mlp_act"), rules, mesh)
    if p.get("w_gate") is not None:
        g = dense(x, p["w_gate"], None, cd)
        g = shard(g, ("batch", "seq", "mlp_act"), rules, mesh)
        h = activation(cfg.act, g) * h
    else:
        h = activation(cfg.act, h)
    y = dense(h, p["w_out"], p.get("b_out"), cd)
    return shard(y, ("batch", "res_seq", "embed_act"), rules, mesh)
