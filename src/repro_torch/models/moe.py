"""Mixture-of-Experts FFN: softmax router, top-k, static-capacity
dispatch, batched SwiGLU experts, combine; expert-parallel on a mesh.

Port of ``repro/models/moe.py``. Routing: an f32 softmax router, the top
``k`` experts of each token (ties to the lower expert id, as
``jax.lax.top_k`` breaks them) and their gates renormalised to sum to
one. Each expert takes at most C = ceil(T·k/E·capacity_factor) tokens, T
the tokens of the call on this rank: a token's slot in an expert is its
running count over the flattened (B·S) tokens that chose it, and a token
past the capacity is dropped by that expert (the reference's capacity
semantics, kept as they are: C depends on T, so prefill, decode and the
train-mode forward route with different capacities). A Switch-style
load-balancing aux loss is returned to the trainer.

The combine differs from the reference's scatter-add
(``y.at[slots].add``) in form only: each token sums its ≤ k expert
outputs in ascending expert order through the inverse map (token, k) ->
(expert, slot), with no atomics, so a call gives the same bits every
time on the card. The expert products are batched matrix products; the
reference computes them outside any kernel too.

On a mesh (``RunConfig.mesh``) the reference's ``shard_map`` becomes a
per-rank region (``distributed.regions``): the experts split over
``model`` (E / n_model each, ``n_experts`` must divide), each data rank
routes its own batch rows (all rows when the batch does not divide the
data dims) with C from its local token count, the expert weights are
all-gathered over the data dims (the FSDP gather; a reduce-scatter in the
backward), each ``model`` rank dispatches the tokens that chose its
experts and sums each token's own experts in ascending id order, and one
all-reduce over ``model`` adds the ranks' partial outputs. That sum's
order is the collective's (fixed for a group and its size: on one rank a
copy, on two an exact commutative add, beyond that the ring or tree of
the backend), so a token whose experts lie on three or more ranks may
differ from the one-rank sum by rounding, and repeats its bits run to
run. The router runs as DTensor ops, the top-k per rank.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from repro_torch.distributed.regions import Region, block_offset
from repro_torch.distributed.sharding import mesh_shape, shard

from .common import ParamDef, Tree, activation
from .config import ModelConfig, RunConfig
from .ffn import ffn_apply, ffn_defs


def moe_defs(cfg: ModelConfig, param_dtype: torch.dtype) -> Tree:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_expert
    defs = {
        "router": ParamDef((d, e), param_dtype, ("embed_act", None),
                           scale=0.02),
        "w_gate": ParamDef((e, d, f), param_dtype, ("expert", "embed", None)),
        "w_in": ParamDef((e, d, f), param_dtype, ("expert", "embed", None)),
        "w_out": ParamDef((e, f, d), param_dtype, ("expert", None, "embed")),
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
    ids, gates = _top_k(probs, cfg)
    return ids, gates, probs


def _top_k(probs: torch.Tensor, cfg: ModelConfig
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(ids, renormalised gates) of the top k by a stable sort."""
    gates, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = gates[..., :cfg.top_k], ids[..., :cfg.top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return ids, gates


def _assignments(ids: torch.Tensor, n_experts: int) -> torch.Tensor:
    """(T, E) f32: how many of each token's k picks are expert e. Exact
    counts added by ``scatter_add_``, the same ops on every device
    (``one_hot`` checks its indices on the CPU only, so its op count
    would differ by device; ``launch/op_cost.py`` compares them)."""
    flat = ids.reshape(-1, ids.shape[-1])
    out = torch.zeros((flat.shape[0], n_experts), dtype=torch.float32,
                      device=ids.device)
    return out.scatter_add_(1, flat, torch.ones(flat.shape,
                                                dtype=torch.float32,
                                                device=ids.device))


def aux_load_balance_loss(ids: torch.Tensor, probs: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-Transformer load-balancing loss: E · Σ_e f_e · p̄_e."""
    f_e = _assignments(ids, n_experts).mean(0)
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
                              capacity: int, cfg: ModelConfig,
                              e_off: int = 0) -> torch.Tensor:
    """Capacity dispatch over the experts [e_off, e_off + E_l) whose
    weights are given (E_l of them): x_flat (T, D), ids and gates (T, k)
    -> (T, D) in the experts' dtype, each token's picks among those
    experts summed in ascending expert order (zero for the others)."""
    t, d = x_flat.shape
    e, c = w_in.shape[0], capacity
    dev = x_flat.device

    # (T, E_l) assignment, each token's slot in each local expert's buffer
    local_ids = ids - e_off
    mine = (local_ids >= 0) & (local_ids < e)
    local_ids = torch.clamp(local_ids, 0, e - 1)
    assign = torch.zeros((t, e), dtype=torch.int32, device=dev)
    assign.scatter_add_(1, local_ids, mine.to(torch.int32))
    pos = torch.cumsum(assign, dim=0) - 1
    keep = (assign > 0) & (pos < c)
    slot = torch.where(keep, pos, c)             # overflow -> trash slot

    # (E_l, C+1) token-index table: sentinel t (the zero pad row); the
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
    ids_o = torch.gather(local_ids, 1, order)
    gates_o = torch.gather(gates, 1, order)
    slot_o = torch.gather(slot, 1, ids_o)        # (T, k)
    kept = torch.gather(mine, 1, order) & (slot_o < c)
    contrib = ye[ids_o, torch.clamp(slot_o, max=c - 1)]       # (T, k, D)
    contrib = contrib * gates_o[..., None].to(ye.dtype)
    contrib = torch.where(kept[..., None], contrib, contrib.new_zeros(()))
    y = contrib[:, 0]
    for j in range(1, contrib.shape[1]):
        y = y + contrib[:, j]
    return y


def _moe_sharded(p: Tree, x: torch.Tensor, cfg: ModelConfig,
                 rcfg: RunConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel dispatch on ``rcfg.mesh`` (module docstring).
    Returns (y before the shared experts, as a DTensor on the residual
    stream's placement; the aux loss, a plain scalar)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh, rules = rcfg.mesh, rcfg.rules
    cd = rcfg.compute_dtype
    e = cfg.n_experts
    n_model = mesh_shape(mesh).get("model", 1)
    if e % n_model != 0:
        raise ValueError(
            f"moe: n_experts={e} not divisible by the mesh's model dim "
            f"{n_model}")
    s, d = x.shape[1:]
    x = shard(x, ("batch", "seq", "embed_act"), rules, mesh)
    xpl = tuple(x.placements)
    rows = tuple(Shard(0) if q.is_shard(0) else Replicate() for q in xpl)
    names = tuple(mesh.mesh_dim_names)
    wpl = tuple(Shard(0) if n == "model" else Replicate() for n in names)
    r = Region(mesh, [n for n, q in zip(names, rows) if q.is_shard()]
               + (["model"] if "model" in names else []))

    # the router as DTensor ops; its aux loss on the global means
    probs = torch.softmax(torch.matmul(x.float(), p["router"].float()),
                          dim=-1)
    ids, gates = _top_k(r.enter(probs, xpl), cfg)
    f_e = r.leave(_assignments(ids, e), rows).mean(0)
    p_e = probs.reshape(-1, e).mean(0)
    aux = (e * torch.sum(f_e * p_e)).full_tensor()

    # each model rank: its experts, the FSDP-gathered weights
    xl = r.enter(x, xpl)
    wg = r.enter(p["w_gate"], wpl)
    wi = r.enter(p["w_in"], wpl)
    wo = r.enter(p["w_out"], wpl)
    bl = xl.shape[0]
    yl = _dispatch_compute_combine(
        xl.reshape(bl * s, d).to(cd), ids.reshape(bl * s, -1),
        gates.reshape(bl * s, -1), wg.to(cd), wi.to(cd), wo.to(cd),
        _capacity(bl * s, cfg), cfg,
        block_offset(r, wpl, 0, wi.shape[0])).reshape(bl, s, d)
    part = tuple(Partial() if n == "model" else q for n, q in zip(names, xpl))
    y = shard(r.leave(yl, part), ("batch", "res_seq", "embed_act"), rules,
              mesh)
    return y, aux


def moe_apply(p: Tree, x: torch.Tensor, cfg: ModelConfig,
              rcfg: RunConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE block: x (B,S,D) -> (y (B,S,D) in x's dtype, aux_loss f32).
    On a mesh the dispatch is expert-parallel (``_moe_sharded``)."""
    b, s, d = x.shape
    cd = rcfg.compute_dtype
    if rcfg.mesh is not None:
        y, aux = _moe_sharded(p, x, cfg, rcfg)
    else:
        ids, gates, probs = _route(x, p["router"], cfg)
        aux = aux_load_balance_loss(ids, probs, cfg.n_experts)
        y = _dispatch_compute_combine(
            x.reshape(b * s, d).to(cd), ids.reshape(b * s, -1),
            gates.reshape(b * s, -1), p["w_gate"].to(cd), p["w_in"].to(cd),
            p["w_out"].to(cd), _capacity(b * s, cfg), cfg).reshape(b, s, d)
    if "shared" in p:
        y = y + ffn_apply(p["shared"], x, _shared_cfg(cfg), rcfg)
    y = shard(y, ("batch", "res_seq", "embed_act"), rcfg.rules, rcfg.mesh)
    return y.to(x.dtype), aux
