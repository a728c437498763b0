"""Language-model assembly: embeddings, stack, head, loss, serving steps.

Port of ``repro/models/lm.py``. ``build_model(cfg, rcfg)`` returns a
``Model`` with

  * ``defs`` / ``init`` / ``abstract`` / ``specs`` / ``n_params`` — the
    parameter tree (nested dicts of tensors with the reference's keys),
    its meta-tensor stand-ins and its partition specs,
  * ``forward(params, batch, mode=...)`` — logits, caches, aux loss,
  * ``loss_fn(params, batch)``            — train-mode forward + CE loss,
  * ``prefill(params, batch)``            — last-position logits + caches,
  * ``decode_step(params, batch, caches, position)`` — one token; the
    caches are updated in place,
  * ``cache_defs(batch, max_seq)``        — KV/state cache ParamDefs
    (``abstract_caches`` / ``cache_specs``).

On ``rcfg.mesh`` the parameters and caches are DTensors placed by the
logical axes of their ParamDefs, activations are placed by ``shard`` at
the reference's annotation points, and the embedding lookup and the
cross-entropy run per rank on their local vocab blocks (``_lookup``,
``_sharded_xent``).

Batches: ``{"tokens": (B,S) int, "labels": (B,S), "mask": (B,S)}``; the
frontend-stub archs (VLM / audio) carry precomputed ``embeds`` (B,S,D) in
place of ``tokens`` (``models/frontends.py``), have no embedding table and
always an ``lm_head``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.regions import (Region, block_offset,
                                            mesh_context, whole)
from repro_torch.distributed.sharding import (placements_for, shard,
                                              spec_tree_for)

from .common import (ParamDef, Tree, abstract_params, apply_norm,
                     init_params, norm_defs, param_count, placer)
from .config import ModelConfig, RunConfig
from .transformer import stack_apply, stack_cache_defs, stack_defs


def model_defs(cfg: ModelConfig, param_dtype: torch.dtype) -> Tree:
    d: Dict[str, Tree] = {}
    if cfg.frontend == "none":
        d["embed"] = ParamDef((cfg.vocab, cfg.d_model), param_dtype,
                              ("vocab", "embed"), init="embed")
    d["stack"] = stack_defs(cfg, param_dtype)
    d["final_norm"] = norm_defs(cfg.norm, cfg.d_model, param_dtype)
    if not cfg.tie_embeddings or cfg.frontend != "none":
        d["lm_head"] = ParamDef((cfg.d_model, cfg.vocab), param_dtype,
                                ("embed", "vocab"), init="embed")
    return d


def _lookup(table: torch.Tensor, tokens: torch.Tensor,
            rcfg: RunConfig) -> torch.Tensor:
    """table[tokens] on a mesh: each ``model`` rank looks up the tokens of
    its vocab rows (the table gathered over its FSDP dims) and zeros the
    rest, and one all-reduce over ``model`` sums the parts (DTensor has no
    rule for ``F.embedding`` on a sharded table)."""
    from torch.distributed.tensor import Partial, Replicate

    mesh, rules = rcfg.mesh, rcfg.rules
    tok_pl = placements_for(("batch", "seq"), rules, mesh, tokens.shape)
    tab_pl = tuple(p if p.is_shard(0) else Replicate()
                   for p in placements_for(("vocab", "embed"), rules, mesh,
                                           table.shape))
    r = Region(mesh, [n for n, a, b in zip(mesh.mesh_dim_names, tok_pl,
                                            tab_pl)
                      if a.is_shard() or b.is_shard()])
    tok = r.enter(tokens, tok_pl)
    tab = r.enter(table, tab_pl)
    v_l = tab.shape[0]
    idx = tok - block_offset(r, tab_pl, 0, v_l)
    mine = (idx >= 0) & (idx < v_l)
    x = tab[torch.clamp(idx, 0, v_l - 1)]
    x = torch.where(mine[..., None], x, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))
    out = tuple(Partial() if p.is_shard() else q
                for p, q in zip(tab_pl, tok_pl))
    return r.leave(x, out)


def _embed(params: Tree, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
           rcfg: RunConfig) -> torch.Tensor:
    mesh, rules = rcfg.mesh, rcfg.rules
    if cfg.frontend != "none":
        x = batch["embeds"].to(rcfg.compute_dtype)
    else:
        tokens = batch["tokens"].long()
        if mesh is None:
            x = params["embed"][tokens]
        else:   # exact: one model rank holds each token's row
            x = shard(_lookup(params["embed"], tokens, rcfg),
                      ("batch", "res_seq", "embed_act"), rules, mesh)
        x = x.to(rcfg.compute_dtype)
        if cfg.tie_embeddings:
            x = x * torch.sqrt(torch.tensor(float(cfg.d_model),
                                            dtype=rcfg.compute_dtype,
                                            device=x.device))
    return shard(x, ("batch", "res_seq", "embed_act"), rules, mesh)


def _head(params: Tree, x: torch.Tensor, cfg: ModelConfig, rcfg: RunConfig,
          kernel: bool = False) -> torch.Tensor:
    x = apply_norm(cfg.norm, x, params["final_norm"], cfg.norm_eps,
                   kernel=kernel)
    if "lm_head" in params:
        logits = torch.matmul(x, params["lm_head"].to(rcfg.compute_dtype))
    else:
        logits = torch.matmul(x, params["embed"].to(rcfg.compute_dtype).t())
    return shard(logits, ("batch", "seq", "vocab_act"), rcfg.rules,
                 rcfg.mesh)


def _sharded_xent(logits, labels, mask, label_smoothing: float,
                  rcfg: RunConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """``softmax_xent`` on a mesh, per rank on the local (batch, vocab)
    block: the log-sum-exp and the label's logit are summed over the
    ``model`` ranks that split the vocab (the max by an all-reduce that
    carries no gradient), the masked sum and the token count over the
    data ranks that split the batch. Without a vocab split it runs the
    mesh-less arithmetic, so a one-rank mesh gives its bits."""
    from torch.distributed.tensor import Partial, Replicate

    mesh, rules = rcfg.mesh, rcfg.rules
    pl = placements_for(("batch", "seq", "vocab_act"), rules, mesh,
                        logits.shape)
    tok_pl = placements_for(("batch", "seq"), rules, mesh, labels.shape)
    r = Region.over(mesh, pl)
    lf = r.enter(logits, pl).float()
    lab = r.enter(labels, tok_pl).long()
    msk = None if mask is None else r.enter(mask, tok_pl)
    vocab = [n for n, p in zip(r.names, pl) if p.is_shard(2)]
    if not any(r.size(n) > 1 for n in vocab):
        lse = torch.logsumexp(lf, dim=-1)
        ll = torch.gather(lf, -1, lab[..., None])[..., 0]
        mean = lf.mean(dim=-1) if label_smoothing > 0.0 else None
    else:
        # per-token sums: each vocab rank holds a part
        part = tuple(Partial() if n in vocab else p
                     for n, p in zip(r.names, tok_pl))
        v_l = lf.shape[-1]
        m = lf.detach().amax(dim=-1)
        for n in vocab:
            r.all_reduce(m, "max", n)
        se = r.reduce(torch.exp(lf - m[..., None]).sum(dim=-1), part)
        lse = torch.log(se) + m
        idx = lab - block_offset(r, pl, 2, v_l)
        mine = (idx >= 0) & (idx < v_l)
        got = torch.gather(lf, -1, torch.clamp(idx, 0, v_l - 1)[..., None])
        ll = r.reduce(torch.where(mine, got[..., 0], 0.0), part)
        mean = (r.reduce(lf.sum(dim=-1), part) / logits.shape[-1]
                if label_smoothing > 0.0 else None)
    nll = lse - ll
    if label_smoothing > 0.0:
        nll = (1 - label_smoothing) * nll + label_smoothing * (-mean + lse)
    msk = torch.ones_like(nll) if msk is None else msk.float()
    # sums over every token: each batch rank holds a part
    tokens = tuple(Partial() if p.is_shard() else Replicate()
                   for p in tok_pl)
    n = torch.clamp(r.reduce(msk.sum(), tokens), min=1.0)
    return r.reduce((nll * msk).sum(), tokens) / n, n


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor],
                 label_smoothing: float = 0.0,
                 rcfg: Optional[RunConfig] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over masked tokens, f32. Returns (loss, n_tokens). Under a
    mesh (``rcfg.mesh``) the DTensor logits run ``_sharded_xent``."""
    if rcfg is not None and rcfg.mesh is not None:
        return _sharded_xent(logits, labels, mask, label_smoothing, rcfg)
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if label_smoothing > 0.0:
        smooth = -lf.mean(dim=-1) + lse
        nll = (1 - label_smoothing) * nll + label_smoothing * smooth
    mask = torch.ones_like(nll) if mask is None else mask.float()
    n = torch.clamp(mask.sum(), min=1.0)
    return (nll * mask).sum() / n, n


@dataclasses.dataclass
class Model:
    cfg: ModelConfig
    rcfg: RunConfig
    defs: Tree
    # a list to receive (key, group index, SolveStats) of every NODE block
    # solved by a train-mode forward, or None
    node_stats: Optional[list] = None

    # -- parameters ------------------------------------------------------
    def init(self, seed: int = 0, device="cuda") -> Tree:
        """Random parameters at the reference's init scales on ``device``
        (the card unless the caller asks for the CPU), drawn leaf after
        leaf from a generator on ``device`` seeded with ``seed``. On
        ``rcfg.mesh`` each leaf is drawn whole and placed at once (its
        DTensor; each rank keeps its own block), so the values are the
        mesh-less init's, leaf for leaf."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        mesh = self.rcfg.mesh
        return init_params(self.defs, gen, dev, place=None if mesh is None
                           else placer(self.rcfg.rules, mesh))

    def abstract(self) -> Tree:
        """Meta-tensor stand-ins of the parameters (no memory)."""
        return abstract_params(self.defs)

    def specs(self, mesh=None) -> Tree:
        """The parameters' partition specs on ``mesh`` (default
        ``rcfg.mesh``) under ``rcfg.rules``."""
        return spec_tree_for(self.defs, self.rcfg.rules,
                           mesh if mesh is not None else self.rcfg.mesh)

    def n_params(self) -> int:
        return param_count(self.defs)

    # -- forward ---------------------------------------------------------
    def _run(self, params: Tree, batch: Dict[str, torch.Tensor], mode: str,
             caches: Optional[Tree], positions: Optional[torch.Tensor],
             last_only: bool):
        x = _embed(params, batch, self.cfg, self.rcfg)
        y, new_caches, aux = stack_apply(
            params["stack"], x, self.cfg, self.rcfg, mode=mode,
            positions=positions, caches=caches, node_stats=self.node_stats)
        if last_only:
            y = y[:, -1:]
        kernel = self.rcfg.use_pallas and mode in ("prefill", "decode")
        return _head(params, y, self.cfg, self.rcfg, kernel), new_caches, aux

    def forward(self, params: Tree, batch: Dict[str, torch.Tensor], *,
                mode: str = "train", caches: Optional[Tree] = None,
                positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[Tree], torch.Tensor]:
        """(logits (B,S,V), new caches or None, aux loss); DTensors on a
        mesh."""
        with mesh_context(self.rcfg.mesh):
            return self._run(params, batch, mode, caches, positions, False)

    def loss_fn(self, params: Tree, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(total loss, metrics); on a mesh the loss and metrics are plain
        tensors, the same on every rank."""
        with mesh_context(self.rcfg.mesh):
            logits, _, aux = self._run(params, batch, "train", None, None,
                                       False)
            loss, n = softmax_xent(logits, batch["labels"],
                                   batch.get("mask"),
                                   self.rcfg.label_smoothing, self.rcfg)
            total = loss + self.cfg.router_aux_coef * aux
        return total, {"ce_loss": loss, "aux_loss": aux, "tokens": n}

    # -- serving ---------------------------------------------------------
    def prefill(self, params: Tree, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Tree]:
        """(logits of the last position (B,V), caches). Only the last
        position leaves prefill, so the head runs on it alone (at 4 x 4096
        tokens and a 256k vocab the full logits would be 8.4 GB in bf16).
        On a mesh the caches are DTensors placed by ``cache_specs`` and
        the logits are gathered whole."""
        with mesh_context(self.rcfg.mesh):
            logits, caches, _ = self._run(params, batch, "prefill", None,
                                          None, True)
            return whole(logits[:, -1]), caches

    def decode_step(self, params: Tree, batch: Dict[str, torch.Tensor],
                    caches: Tree, position) -> Tuple[torch.Tensor, Tree]:
        """One new token: batch['tokens'] (B,1) (or 'embeds' (B,1,D) for
        the frontend-stub archs), ``position`` its global index (int or 0-d
        tensor). ``caches`` is updated in place (the reference donates it)
        and returned."""
        ref = batch["tokens"] if "tokens" in batch else batch["embeds"]
        pos = torch.as_tensor(position, device=ref.device).reshape(1, 1)
        pos = pos.expand(ref.shape[0], 1)
        with mesh_context(self.rcfg.mesh):
            logits, caches, _ = self._run(params, batch, "decode", caches,
                                          pos, False)
            return whole(logits[:, -1]), caches

    def cache_defs(self, batch: int, max_seq: int,
                   cache_dtype: torch.dtype = torch.bfloat16) -> Tree:
        return stack_cache_defs(self.cfg, batch, max_seq, cache_dtype)

    def abstract_caches(self, batch: int, max_seq: int,
                        cache_dtype: torch.dtype = torch.bfloat16) -> Tree:
        return abstract_params(self.cache_defs(batch, max_seq, cache_dtype))

    def cache_specs(self, batch: int, max_seq: int,
                    cache_dtype: torch.dtype = torch.bfloat16,
                    mesh=None) -> Tree:
        return spec_tree_for(self.cache_defs(batch, max_seq, cache_dtype),
                           self.rcfg.rules,
                           mesh if mesh is not None else self.rcfg.mesh)


def build_model(cfg: ModelConfig, rcfg: Optional[RunConfig] = None) -> Model:
    rcfg = rcfg or RunConfig()
    return Model(cfg=cfg, rcfg=rcfg, defs=model_defs(cfg, rcfg.param_dtype))
