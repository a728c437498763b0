"""Mixture-of-Experts FFN: softmax router, top-k, static-capacity
dispatch, batched SwiGLU experts, combine.

Port of ``repro/models/moe.py``'s single-shard form (one card holds every
expert). Routing: an f32 softmax router, the top ``k`` experts of each
token (ties to the lower expert id, as ``jax.lax.top_k`` breaks them)
and their gates renormalised to sum to one. Each expert takes at most
C = ceil(T·k/E·capacity_factor) tokens, T the tokens of the call: a
token's slot in an expert is its running count over the flattened (B·S)
tokens that chose it, and a token past the capacity is dropped by that
expert (the reference's capacity semantics, kept as they are: C depends
on T, so prefill, decode and the train-mode forward route with different
capacities). A Switch-style load-balancing aux loss is returned to the
trainer.

The combine differs from the reference's scatter-add
(``y.at[slots].add``) in form only: each token sums its ≤ k expert
outputs in ascending expert order through the inverse map (token, k) ->
(expert, slot), with no atomics, so a call gives the same bits every
time on the card. The expert products are batched matrix products; the
reference computes them outside any kernel too.

The reference's expert-parallel path (``mesh`` with a ``model`` axis)
belongs to the distributed slice: a ``RunConfig.mesh`` raises.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from .common import ParamDef, Tree, activation
from .config import ModelConfig, RunConfig
from .ffn import ffn_apply, ffn_defs


def moe_defs(cfg: ModelConfig, param_dtype: torch.dtype) -> Tree:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_expert
    defs = {
        "router": ParamDef((d, e), param_dtype, scale=0.02),
        "w_gate": ParamDef((e, d, f), param_dtype),
        "w_in": ParamDef((e, d, f), param_dtype),
        "w_out": ParamDef((e, f, d), param_dtype),
    }
    if cfg.n_shared_experts:
        defs["shared"] = ffn_defs(_shared_cfg(cfg), param_dtype,
                                  d_ff=cfg.n_shared_experts * f)
    return defs


def _shared_cfg(cfg: ModelConfig) -> ModelConfig:
    return cfg.scaled(d_ff=cfg.n_shared_experts * cfg.d_expert,
                      mlp_bias=False)


def _capacity(tokens_local: int, cfg: ModelConfig) -> int:
    c = tokens_local * cfg.top_k / cfg.n_experts * cfg.capacity_factor
    return max(int(math.ceil(c)), 1)


def _route(x: torch.Tensor, router_w: torch.Tensor, cfg: ModelConfig
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router: (ids (B,S,k) int64, gates (B,S,k) f32, probs (B,S,E) f32).

    The top k come from a stable descending sort, so equal probabilities
    go to the lower expert id first, as ``jax.lax.top_k`` orders them
    (``torch.topk`` promises no order among ties)."""
    logits = torch.matmul(x.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[..., :cfg.top_k], ids[..., :cfg.top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return ids, gates, probs


def aux_load_balance_loss(ids: torch.Tensor, probs: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-Transformer load-balancing loss: E · Σ_e f_e · p̄_e."""
    assign = torch.nn.functional.one_hot(ids, n_experts).float().sum(-2)
    f_e = assign.reshape(-1, n_experts).mean(0)
    p_e = probs.reshape(-1, n_experts).mean(0)
    return n_experts * torch.sum(f_e * p_e)


def _expert_compute(xe: torch.Tensor, w_gate: torch.Tensor,
                    w_in: torch.Tensor, w_out: torch.Tensor,
                    act: str) -> torch.Tensor:
    """Batched expert SwiGLU: xe (E, C, D) -> (E, C, D)."""
    g = torch.bmm(xe, w_gate)
    h = activation(act, g) * torch.bmm(xe, w_in)
    return torch.bmm(h, w_out)


def _dispatch_compute_combine(x_flat: torch.Tensor, ids: torch.Tensor,
                              gates: torch.Tensor, w_gate: torch.Tensor,
                              w_in: torch.Tensor, w_out: torch.Tensor,
                              capacity: int, cfg: ModelConfig
                              ) -> torch.Tensor:
    """Capacity dispatch over every expert: x_flat (T, D), ids and gates
    (T, k) -> (T, D) in the experts' dtype."""
    t, d = x_flat.shape
    e, c = w_in.shape[0], capacity
    dev = x_flat.device

    # (T, E) assignment, each token's slot in each expert's buffer
    assign = torch.zeros((t, e), dtype=torch.int32, device=dev)
    assign.scatter_(1, ids, 1)
    pos = torch.cumsum(assign, dim=0) - 1
    keep = (assign > 0) & (pos < c)
    slot = torch.where(keep, pos, c)             # overflow -> trash slot

    # (E, C+1) token-index table: sentinel t (the zero pad row); the
    # pairs that are not kept all land in the trash column, dropped
    slots = torch.full((e, c + 1), t, dtype=torch.long, device=dev)
    e_idx = torch.arange(e, device=dev)[None].expand(t, e)
    tok_idx = torch.arange(t, device=dev)[:, None].expand(t, e)
    slots[e_idx.reshape(-1), slot.reshape(-1)] = tok_idx.reshape(-1)
    slots = slots[:, :c]

    x_pad = torch.cat([x_flat, x_flat.new_zeros((1, d))], 0)
    ye = _expert_compute(x_pad[slots], w_gate, w_in, w_out, cfg.act)

    # combine through the inverse map (token, k) -> (expert, slot), the
    # k contributions summed in ascending expert order
    order = torch.argsort(ids, dim=1, stable=True)
    ids_o = torch.gather(ids, 1, order)
    gates_o = torch.gather(gates, 1, order)
    slot_o = torch.gather(slot, 1, ids_o)        # (T, k)
    kept = slot_o < c
    contrib = ye[ids_o, torch.clamp(slot_o, max=c - 1)]       # (T, k, D)
    contrib = contrib * gates_o[..., None].to(ye.dtype)
    contrib = torch.where(kept[..., None], contrib, contrib.new_zeros(()))
    y = contrib[:, 0]
    for j in range(1, contrib.shape[1]):
        y = y + contrib[:, j]
    return y


def moe_apply(p: Tree, x: torch.Tensor, cfg: ModelConfig,
              rcfg: RunConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE block: x (B,S,D) -> (y (B,S,D) in x's dtype, aux_loss f32)."""
    if rcfg.mesh is not None:
        raise NotImplementedError(
            "moe_apply with a mesh (expert-parallel dispatch over a "
            "'model' axis) is part of slice I (distribution) of the port; "
            "one card runs the single-shard form with mesh=None")
    b, s, d = x.shape
    cd = rcfg.compute_dtype
    ids, gates, probs = _route(x, p["router"], cfg)
    aux = aux_load_balance_loss(ids, probs, cfg.n_experts)
    y = _dispatch_compute_combine(
        x.reshape(b * s, d).to(cd), ids.reshape(b * s, -1),
        gates.reshape(b * s, -1), p["w_gate"].to(cd), p["w_in"].to(cd),
        p["w_out"].to(cd), _capacity(b * s, cfg), cfg).reshape(b, s, d)
    if "shared" in p:
        y = y + ffn_apply(p["shared"], x, _shared_cfg(cfg), rcfg)
    return y.to(x.dtype), aux
