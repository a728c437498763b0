"""Transformer stack: block composition, the layer loop, caches; and the
node18 block with its NODE form (the paper's ResNet → NODE step).

Port of ``repro/models/transformer.py``. A *block* is (norm → mixer →
residual, norm → ffn/moe → residual), or the parallel variant (attention
and ffn/moe both read one norm); a Mamba-2 block (kind ``ssm``) is norm →
mixer → residual alone. The mixer is attention (kinds ``attn`` and
``moe_attn``, the latter with the MoE block in place of the FFN), an
RG-LRU recurrent block (``rec``) or the Mamba-2 SSD block (``ssm``);
hybrid (RecurrentGemma) stacks repeat a unit of kinds (("rec", "rec",
"attn")) over groups and apply the remainder as a tail. Parameters keep
the reference's tree: ``u{j}_{kind}`` leaves stacked on a leading groups
dim (logical axis ``layers``), ``tail{j}_{kind}`` unstacked. The reference scans over the groups
(``lax.scan``); the port loops over them in Python, on views of the
stacked leaves. The MoE aux loss is summed over the layers.

NODE mode (the paper's contribution inside the LM): in train mode with
``rcfg.node.enabled`` every block's residual branch becomes the dynamics
of an ODE block, z(1) = z(0) + ∫₀¹ (block(z) - z) dt, solved by
``node_block_solve`` over the group's parameter views (ACA gradients
reach the stacked leaves through them). ``rcfg.use_pallas`` turns on the
fused solver path of every NODE block (K1/K2; K3/K4 under
``batch_axis=0``). Prefill and decode stay discrete, as in the reference.

On ``rcfg.mesh`` a NODE block runs in a per-rank region
(``_node_block_on_mesh``): each rank solves its batch block of the
residual stream on plain tensors, so K1-K4 launch on it. With
``batch_axis=None`` (lockstep, one grid for the whole batch) the field
wraps the block back into a DTensor and runs the block on the sharded
parameters, and every reduction of the solver is summed over the batch
ranks (``distributed.regions.SolveGroup``): every rank takes the whole
batch's trials, so the field's collectives (FSDP gathers, tensor-parallel
reductions, the MoE dispatch) match on every rank. With ``batch_axis=0``
each row is whole on one rank: the field runs the mesh-less block on the
parameters gathered whole once a block (the per-sample field runs under
``torch.func.vmap``, which DTensors do not), and issues no collective.

``rcfg.remat == "block"`` runs each layer group's body of a train step
under ``torch.utils.checkpoint`` (non-reentrant): its activations are
recomputed in the backward, NODE blocks included, as the reference's
``jax.checkpoint`` over its scanned groups; the tail never is.

``TransformerBlock`` is the node18 block as a module (``block_apply`` of
kind ``attn`` over parameters named by the reference's keys, ``norm1.w``,
``mixer.wq``, …, ``ffn.w_out``, so that ``convert.params_from_jax`` loads
the reference's weights directly); ``branch_fn`` is the residual branch
that becomes the NODE dynamics.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call
from torch.utils import _pytree as pytree

from repro_torch.core.integrate import SolveStats
from repro_torch.core.node_block import NodeConfig, node_block_solve
from repro_torch.device import resolve_device
from repro_torch.distributed.collectives import BatchShard
from repro_torch.distributed.regions import Region, SolveGroup, mesh_context
from repro_torch.distributed.sharding import mesh_shape

from .attention import attention_apply, attn_defs
from .common import (ParamDef, Tree, apply_norm, map_defs, norm_defs,
                     normal_init)
from .config import ModelConfig, RunConfig
from .ffn import ffn_apply, ffn_defs
from .mamba2 import mamba2_block_apply, mamba2_cache_defs, mamba2_defs
from .moe import moe_apply, moe_defs
from .rglru import rglru_block_apply, rglru_cache_defs, rglru_defs


# ----------------------------------------------------------------------------
# Per-layer definitions
# ----------------------------------------------------------------------------

def layer_kinds(cfg: ModelConfig) -> List[str]:
    """Block kind per layer: 'attn' | 'moe_attn' | 'rec' | 'ssm'."""
    if cfg.family == "ssm":
        return ["ssm"] * cfg.n_layers
    if cfg.family == "hybrid":
        pat = cfg.pattern or ("rec", "rec", "attn")
        return [pat[i % len(pat)] for i in range(cfg.n_layers)]
    if cfg.family == "moe":
        return ["moe_attn"] * cfg.n_layers
    return ["attn"] * cfg.n_layers


def block_defs(cfg: ModelConfig, kind: str, param_dtype: torch.dtype
               ) -> Tree:
    d = {"norm1": norm_defs(cfg.norm, cfg.d_model, param_dtype)}
    if kind == "ssm":
        d["mixer"] = mamba2_defs(cfg, param_dtype)
        return d  # mamba2 blocks are single-residual (no separate ffn)
    if kind == "rec":
        d["mixer"] = rglru_defs(cfg, param_dtype)
    else:
        d["mixer"] = attn_defs(cfg, param_dtype)
    if not cfg.parallel_block:
        d["norm2"] = norm_defs(cfg.norm, cfg.d_model, param_dtype)
    if kind == "moe_attn":
        d["moe"] = moe_defs(cfg, param_dtype)
    else:
        d["ffn"] = ffn_defs(cfg, param_dtype, gated=(cfg.act == "silu"))
    return d


def block_cache_defs(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                     cache_dtype: torch.dtype) -> Tree:
    if kind == "ssm":
        return mamba2_cache_defs(cfg, batch)
    if kind == "rec":
        return rglru_cache_defs(cfg, batch)
    # attention KV cache; window-limited archs only need the window
    hk, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    slots = max_seq if cfg.window == 0 else min(max_seq, cfg.window)
    kv = ("batch", "kv_seq", None, None)
    return {"k": ParamDef((batch, slots, hk, dh), cache_dtype, kv,
                          init="zeros"),
            "v": ParamDef((batch, slots, hk, dh), cache_dtype, kv,
                          init="zeros"),
            "len": ParamDef((), torch.int32, (), init="zeros")}


# ----------------------------------------------------------------------------
# Block application
# ----------------------------------------------------------------------------

def block_apply(p: Tree, x: torch.Tensor, cfg: ModelConfig, rcfg: RunConfig,
                kind: str, *, mode: str = "train",
                positions: Optional[torch.Tensor] = None,
                cache: Optional[Tree] = None
                ) -> Tuple[torch.Tensor, Optional[Tree], torch.Tensor]:
    """One block with residuals. Returns (y, new_cache, aux_loss). Under
    ``use_pallas`` the serving modes run every RMSNorm through K7."""
    kernel = rcfg.use_pallas and mode in ("prefill", "decode")
    aux = torch.zeros((), device=x.device)
    h = apply_norm(cfg.norm, x, p["norm1"], cfg.norm_eps, kernel=kernel)
    if kind == "ssm":
        mix, new_cache = mamba2_block_apply(p["mixer"], h, cfg, rcfg,
                                            mode=mode, cache=cache)
        return x + mix, new_cache, aux
    if kind == "rec":
        mix, new_cache = rglru_block_apply(p["mixer"], h, cfg, rcfg,
                                           mode=mode, cache=cache)
    else:
        mix, new_cache = attention_apply(p["mixer"], h, cfg, rcfg, mode=mode,
                                         positions=positions, cache=cache)
    if cfg.parallel_block:
        # Command-R: y = x + attn(n(x)) + ffn(n(x))
        f, aux = _ffn_or_moe(kind, p, h, cfg, rcfg, aux)
        return x + mix + f, new_cache, aux
    y = x + mix
    h2 = apply_norm(cfg.norm, y, p["norm2"], cfg.norm_eps, kernel=kernel)
    f, aux = _ffn_or_moe(kind, p, h2, cfg, rcfg, aux)
    return y + f, new_cache, aux


def _ffn_or_moe(kind: str, p: Tree, h: torch.Tensor, cfg: ModelConfig,
                rcfg: RunConfig, aux: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    if kind == "moe_attn":
        return moe_apply(p["moe"], h, cfg, rcfg)
    return ffn_apply(p["ffn"], h, cfg, rcfg), aux


def _node_block(p: Tree, x: torch.Tensor, cfg: ModelConfig,
                rcfg: RunConfig, kind: str,
                positions: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, SolveStats]:
    """The block as an ODE block (the reference's ``_apply_one`` in NODE
    mode): z(1) = x + ∫ (block(z) - z) dt over ``p``, with the gradients of
    ``rcfg.node.grad_method``. Returns (z(1), the solve's stats)."""
    ncfg = rcfg.node
    if rcfg.use_pallas and not ncfg.use_pallas:
        ncfg = dataclasses.replace(ncfg, use_pallas=True)
    if rcfg.mesh is not None:
        return _node_block_on_mesh(p, x, cfg, rcfg, kind, positions, ncfg)
    if ncfg.batch_axis is None:
        def fn(pp, z, t):
            return block_apply(pp, z, cfg, rcfg, kind,
                               positions=positions)[0] - z
    elif ncfg.batch_axis in (0, -x.dim()):
        # the batched engine hands the field one sample (S, D)
        def fn(pp, z, t):
            return block_apply(pp, z.unsqueeze(0), cfg, rcfg, kind,
                               positions=positions)[0][0] - z
    else:
        raise ValueError(
            f"NODE blocks batch over the stack's batch axis 0; got "
            f"batch_axis={ncfg.batch_axis}")
    return node_block_solve(fn, p, x, ncfg)


def _share(placements, sizes) -> float:
    """1 over the number of ranks that hold the same block of a tensor
    placed by ``placements``."""
    rep = 1
    for p, n in zip(placements, sizes):
        if not p.is_shard():
            rep *= n
    return 1.0 / rep


def _node_block_on_mesh(p: Tree, x, cfg: ModelConfig, rcfg: RunConfig,
                        kind: str, positions: Optional[torch.Tensor],
                        ncfg: NodeConfig) -> Tuple[torch.Tensor, SolveStats]:
    """``_node_block`` on ``rcfg.mesh`` (see the module docstring): ``x``
    a DTensor, its batch split over the data dims; returns z(1) with
    ``x``'s placements and the stats, the same on every rank."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh = rcfg.mesh
    x_pl = tuple(x.placements)
    r = Region.over(mesh, x_pl)
    z0 = r.enter(x, x_pl)
    leaves, spec = pytree.tree_flatten(p)
    split = [n for n, q in zip(r.names, x_pl) if q.is_shard()]
    if ncfg.batch_axis is None:
        # the FSDP gather of the block's weights over the batch dims, once
        # a solve (every evaluation reads them); tensor-parallel splits stay
        pls = [tuple(Replicate() if n in split else q
                     for n, q in zip(r.names, v.placements))
               for v in leaves]
        leaves = [v.redistribute(mesh, pl) for v, pl in zip(leaves, pls)]
        sizes = list(mesh_shape(mesh).values())
        group = SolveGroup(mesh, split, args_layout=[
            (_share(pl, sizes), v.numel()) for v, pl in zip(leaves, pls)])

        def fn(pp, z, t):
            with mesh_context(mesh):
                pd = pytree.tree_unflatten(
                    [DTensor.from_local(v, mesh, pl, run_check=False)
                     for v, pl in zip(pytree.tree_leaves(pp), pls)], spec)
                zd = r.leave(z, x_pl)
                y = block_apply(pd, zd, cfg, rcfg, kind,
                                positions=positions)[0] - zd
                return y.redistribute(mesh, x_pl).to_local()

        local = pytree.tree_unflatten([v.to_local() for v in leaves], spec)
        z1, stats = node_block_solve(fn, local, z0, ncfg, group=group)
    elif ncfg.batch_axis in (0, -x.dim()):
        whole = tuple(Replicate() for _ in r.names)
        pw = pytree.tree_unflatten([r.enter(v, whole) for v in leaves], spec)
        plain = rcfg.with_(mesh=None)

        def fn(pp, z, t):
            return block_apply(pp, z.unsqueeze(0), cfg, plain, kind,
                               positions=positions)[0][0] - z

        z1, stats = node_block_solve(fn, pw, z0, ncfg)
        # every rank reports every row's stats, in the batch's order
        shard = BatchShard(mesh, split, x.shape[0])
        stats = SolveStats(*shard.gather_rows(list(stats), 0))
    else:
        raise ValueError(
            f"NODE blocks batch over the stack's batch axis 0; got "
            f"batch_axis={ncfg.batch_axis}")
    return r.leave(z1, x_pl), stats


# ----------------------------------------------------------------------------
# Stack
# ----------------------------------------------------------------------------

def _stack_defs(defs: Tree, n: int) -> Tree:
    """Prepend a stacked-layers dim (logical ``layers``) to every ParamDef
    leaf."""
    return map_defs(lambda d: dataclasses.replace(
        d, shape=(n,) + d.shape, logical=("layers",) + d.logical), defs)


def _index(tree: Tree, i: int) -> Tree:
    """Views of the i-th group of every stacked leaf."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees: List[Tree]) -> Tree:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def stack_plan(cfg: ModelConfig) -> Tuple[Tuple[str, ...], int, List[str]]:
    """(repeating unit kinds, n_groups, tail kinds)."""
    kinds = layer_kinds(cfg)
    if cfg.family == "hybrid":
        pat = cfg.pattern or ("rec", "rec", "attn")
        n_groups = cfg.n_layers // len(pat)
        return tuple(pat), n_groups, kinds[n_groups * len(pat):]
    return (kinds[0],), cfg.n_layers, []


def stack_defs(cfg: ModelConfig, param_dtype: torch.dtype) -> Tree:
    unit, n_groups, tail = stack_plan(cfg)
    d: Dict[str, Tree] = {}
    for j, kind in enumerate(unit):
        d[f"u{j}_{kind}"] = _stack_defs(block_defs(cfg, kind, param_dtype),
                                        n_groups)
    for j, kind in enumerate(tail):
        d[f"tail{j}_{kind}"] = block_defs(cfg, kind, param_dtype)
    return d


def stack_cache_defs(cfg: ModelConfig, batch: int, max_seq: int,
                     cache_dtype: torch.dtype) -> Tree:
    unit, n_groups, tail = stack_plan(cfg)
    d: Dict[str, Tree] = {}
    for j, kind in enumerate(unit):
        d[f"u{j}_{kind}"] = _stack_defs(
            block_cache_defs(cfg, kind, batch, max_seq, cache_dtype),
            n_groups)
    for j, kind in enumerate(tail):
        d[f"tail{j}_{kind}"] = block_cache_defs(cfg, kind, batch, max_seq,
                                                cache_dtype)
    return d


def stack_apply(params: Tree, x: torch.Tensor, cfg: ModelConfig,
                rcfg: RunConfig, *, mode: str = "train",
                positions: Optional[torch.Tensor] = None,
                caches: Optional[Tree] = None,
                node_stats: Optional[list] = None
                ) -> Tuple[torch.Tensor, Optional[Tree], torch.Tensor]:
    """Apply the full stack. Returns (y, new_caches, aux_loss_sum).

    ``prefill`` returns fresh caches (the groups' stacked like the
    parameters); ``decode`` updates ``caches`` in place through the
    groups' views and returns them.

    In NODE mode (train mode, ``rcfg.node.enabled``) every block is an ODE
    block, its aux loss zero as in the reference; ``node_stats``, when a
    list, receives (key, group index or None, SolveStats) per block, once
    (a ``remat`` recompute records nothing).

    ``rcfg.remat == "block"`` in a train step with autograd on (and more
    than one group, as the reference's scan): each group's body runs under
    ``torch.utils.checkpoint``."""
    node = rcfg.node.enabled and mode == "train"
    unit, n_groups, tail = stack_plan(cfg)
    aux_total = torch.zeros((), device=x.device)
    fresh: Dict[str, List[Tree]] = {}

    def one(p, x, key, i, kind, c, record=True):
        if node:
            z, stats = _node_block(p, x, cfg, rcfg, kind, positions)
            if node_stats is not None and record:
                node_stats.append((key, i, stats))
            return z, None, torch.zeros((), device=x.device)
        return block_apply(p, x, cfg, rcfg, kind, mode=mode,
                           positions=positions, cache=c)

    remat = (rcfg.remat == "block" and mode == "train" and n_groups > 1
             and torch.is_grad_enabled())
    for i in range(n_groups):
        if remat:
            x, aux = _remat_group(one, unit, params, x, i, rcfg)
            aux_total = aux_total + aux
            continue
        for j, kind in enumerate(unit):
            key = f"u{j}_{kind}"
            c = _index(caches[key], i) if caches is not None else None
            x, nc, aux = one(_index(params[key], i), x, key, i, kind, c)
            aux_total = aux_total + aux
            fresh.setdefault(key, []).append(nc)
    new_caches: Dict[str, Tree] = {}
    if mode == "prefill" and n_groups:
        new_caches = {k: _stack(v) for k, v in fresh.items()}
    for j, kind in enumerate(tail):
        key = f"tail{j}_{kind}"
        c = caches.get(key) if caches is not None else None
        x, nc, aux = one(params[key], x, key, None, kind, c)
        aux_total = aux_total + aux
        new_caches[key] = nc
    if mode == "decode":
        return x, caches, aux_total
    return x, (new_caches if mode == "prefill" else None), aux_total


def _remat_group(one, unit, params: Tree, x, i: int, rcfg: RunConfig):
    """Group ``i`` of a train step under ``torch.utils.checkpoint``
    (non-reentrant): (its output, its aux loss). The group's parameter
    views are taken inside, so the recompute re-slices them; only the
    first pass records NODE stats. The recompute runs the body to its
    end (no early stop at the last saved tensor), so a step costs one
    more forward of the groups, as the dry run counts it."""
    from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

    first = [True]

    def body(x):
        with mesh_context(rcfg.mesh):
            aux_g = torch.zeros((), device=x.device)
            for j, kind in enumerate(unit):
                key = f"u{j}_{kind}"
                x, _, aux = one(_index(params[key], i), x, key, i, kind,
                                None, record=first[0])
                aux_g = aux_g + aux
            first[0] = False
            return x, aux_g

    with set_checkpoint_early_stop(False):
        return checkpoint(body, x, use_reentrant=False,
                          preserve_rng_state=False)


# ----------------------------------------------------------------------------
# The node18 block as a module, and its NODE form
# ----------------------------------------------------------------------------


class TransformerBlock(nn.Module):
    """The node18 block as a module: ``block_apply`` of kind ``attn`` in
    train mode (y = x + attn(n1(x)); out = y + ffn(n2(y))) over
    ``nn.Parameter``s named by ``block_defs``'s keys (``norm1.w``,
    ``mixer.wq``, …, ``ffn.w_out``).

    f32 weights are drawn with numpy from ``seed`` at the reference's init
    scale (N(0, 1/fan_in); norms at one, biases at zero) on ``device``
    (default the card; a missing card raises).
    """

    def __init__(self, cfg: ModelConfig, rcfg: RunConfig, *, seed: int = 0,
                 device="cuda"):
        super().__init__()
        if cfg.family != "dense" or cfg.norm != "rmsnorm" \
                or cfg.parallel_block:
            raise ValueError(
                f"TransformerBlock is node18's block only: dense, pre-norm, "
                f"RMSNorm, sequential (got family={cfg.family!r}, "
                f"norm={cfg.norm!r}, parallel_block={cfg.parallel_block}); "
                "it takes no MoE, hybrid or SSM family, no LayerNorm and no "
                "parallel block. Those blocks run through block_apply "
                "(build_model(cfg, rcfg))")
        dev = resolve_device(device)
        self.cfg, self.rcfg = cfg, rcfg
        rng = np.random.default_rng(seed)
        self._names = {}
        for key, sub in block_defs(cfg, "attn", torch.float32).items():
            group = nn.Module()
            for name, d in sub.items():
                if d.init == "normal":
                    val = normal_init(rng, d.shape)
                else:
                    val = (torch.ones if d.init == "ones" else torch.zeros)(
                        d.shape)
                group.register_parameter(name, nn.Parameter(val))
            self.add_module(key, group)
            self._names[key] = tuple(sub)
        self.to(device=dev)

    def forward(self, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``block_apply`` (train mode): (B,S,D) -> (B,S,D)."""
        # attribute reads, so that functional_call's swapped tensors are seen
        p = {key: {n: getattr(getattr(self, key), n) for n in names}
             for key, names in self._names.items()}
        return block_apply(p, x, self.cfg, self.rcfg, "attn",
                           positions=positions)[0]


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
    """``ncfg`` with the full checkpoint buffer in place of its segmented
    one: the same gradients bit for bit at more memory, the comparison
    for a segmented config such as ``NODE_TRAIN``."""
    return dataclasses.replace(ncfg, checkpoint_segments=None)
