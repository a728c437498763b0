"""Transformer stack: block composition, the layer loop, caches; and the
node18 block with its NODE form (the paper's ResNet → NODE step).

Port of ``repro/models/transformer.py``. A *block* is (norm → mixer →
residual, norm → ffn → residual), or the parallel variant (attention and
ffn both read one norm). The mixer is attention (kind ``attn``) or an
RG-LRU recurrent block (``rec``); hybrid (RecurrentGemma) stacks repeat a
unit of kinds (("rec", "rec", "attn")) over groups and apply the
remainder as a tail. Parameters keep the reference's tree: ``u{j}_{kind}``
leaves stacked on a leading groups dim, ``tail{j}_{kind}`` unstacked. The
reference scans over the groups (``lax.scan``); the port loops over them
in Python, on views of the stacked leaves. The kinds ``ssm`` (Mamba-2)
and ``moe_attn``, and NODE mode inside the LM stack, are later slices and
raise ``NotImplementedError``.

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

from repro_torch.core.integrate import SolveStats
from repro_torch.core.node_block import NodeConfig, node_block_solve
from repro_torch.device import resolve_device

from .attention import attention_apply, attn_defs
from .common import (ParamDef, Tree, apply_norm, map_defs, norm_defs,
                     normal_init)
from .config import ModelConfig, RunConfig
from .ffn import ffn_apply, ffn_defs
from .rglru import rglru_block_apply, rglru_cache_defs, rglru_defs

_LATER = {
    "ssm": "the Mamba-2 (ssm) block is a later slice of the port (with "
           "kernel K9, ROADMAP queue 1)",
    "moe_attn": "the MoE block is a later slice of the port (dense/MoE "
                "serving, ROADMAP queue 1)",
}


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


def _ported(kind: str) -> None:
    if kind in _LATER:
        raise NotImplementedError(_LATER[kind])


def block_defs(cfg: ModelConfig, kind: str, param_dtype: torch.dtype
               ) -> Tree:
    _ported(kind)
    d = {"norm1": norm_defs(cfg.norm, cfg.d_model, param_dtype)}
    if kind == "rec":
        d["mixer"] = rglru_defs(cfg, param_dtype)
    else:
        d["mixer"] = attn_defs(cfg, param_dtype)
    if not cfg.parallel_block:
        d["norm2"] = norm_defs(cfg.norm, cfg.d_model, param_dtype)
    d["ffn"] = ffn_defs(cfg, param_dtype, gated=(cfg.act == "silu"))
    return d


def block_cache_defs(cfg: ModelConfig, kind: str, batch: int, max_seq: int,
                     cache_dtype: torch.dtype) -> Tree:
    _ported(kind)
    if kind == "rec":
        return rglru_cache_defs(cfg, batch)
    # attention KV cache; window-limited archs only need the window
    hk, dh = cfg.n_kv_heads, cfg.resolved_head_dim
    slots = max_seq if cfg.window == 0 else min(max_seq, cfg.window)
    return {"k": ParamDef((batch, slots, hk, dh), cache_dtype, init="zeros"),
            "v": ParamDef((batch, slots, hk, dh), cache_dtype, init="zeros"),
            "len": ParamDef((), torch.int32, init="zeros")}


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
    _ported(kind)
    kernel = rcfg.use_pallas and mode in ("prefill", "decode")
    aux = torch.zeros((), device=x.device)
    h = apply_norm(cfg.norm, x, p["norm1"], cfg.norm_eps, kernel=kernel)
    if kind == "rec":
        mix, new_cache = rglru_block_apply(p["mixer"], h, cfg, rcfg,
                                           mode=mode, cache=cache)
    else:
        mix, new_cache = attention_apply(p["mixer"], h, cfg, rcfg, mode=mode,
                                         positions=positions, cache=cache)
    if cfg.parallel_block:
        # Command-R: y = x + attn(n(x)) + ffn(n(x))
        return x + mix + ffn_apply(p["ffn"], h, cfg, rcfg), new_cache, aux
    y = x + mix
    h2 = apply_norm(cfg.norm, y, p["norm2"], cfg.norm_eps, kernel=kernel)
    return y + ffn_apply(p["ffn"], h2, cfg, rcfg), new_cache, aux


# ----------------------------------------------------------------------------
# Stack
# ----------------------------------------------------------------------------

def _stack_defs(defs: Tree, n: int) -> Tree:
    """Prepend a stacked-layers dim to every ParamDef leaf."""
    return map_defs(lambda d: dataclasses.replace(d, shape=(n,) + d.shape),
                    defs)


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
                caches: Optional[Tree] = None
                ) -> Tuple[torch.Tensor, Optional[Tree], torch.Tensor]:
    """Apply the full stack. Returns (y, new_caches, aux_loss_sum).

    ``prefill`` returns fresh caches (the groups' stacked like the
    parameters); ``decode`` updates ``caches`` in place through the
    groups' views and returns them."""
    if rcfg.node.enabled and mode == "train":
        raise NotImplementedError(
            "NODE mode inside the LM stack (the reference's _apply_one) is a "
            "later slice of the port (LM training with NODE blocks, ROADMAP "
            "queue 1); the node18 block runs it through "
            "models.transformer.node_block")
    unit, n_groups, tail = stack_plan(cfg)
    aux_total = torch.zeros((), device=x.device)
    fresh: Dict[str, List[Tree]] = {}
    for i in range(n_groups):
        for j, kind in enumerate(unit):
            key = f"u{j}_{kind}"
            c = _index(caches[key], i) if caches is not None else None
            x, nc, aux = block_apply(_index(params[key], i), x, cfg, rcfg,
                                     kind, mode=mode, positions=positions,
                                     cache=c)
            aux_total = aux_total + aux
            fresh.setdefault(key, []).append(nc)
    new_caches: Dict[str, Tree] = {}
    if mode == "prefill" and n_groups:
        new_caches = {k: _stack(v) for k, v in fresh.items()}
    for j, kind in enumerate(tail):
        key = f"tail{j}_{kind}"
        c = caches.get(key) if caches is not None else None
        x, nc, aux = block_apply(params[key], x, cfg, rcfg, kind, mode=mode,
                                 positions=positions, cache=c)
        aux_total = aux_total + aux
        new_caches[key] = nc
    if mode == "decode":
        return x, caches, aux_total
    return x, (new_caches if mode == "prefill" else None), aux_total


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
                f"only the dense pre-norm RMSNorm attention block is ported "
                f"as a module (got family={cfg.family!r}, norm={cfg.norm!r}, "
                f"parallel_block={cfg.parallel_block}); the other kinds "
                "come with slice G (ROADMAP queue 1)")
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
    """``ncfg`` with the full checkpoint buffer (segmented ACA, which the
    reference's ``checkpoint_segments="auto"`` asks for, is slice D; its
    gradients are the same)."""
    return dataclasses.replace(ncfg, checkpoint_segments=None)
