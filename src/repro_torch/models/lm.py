"""Language-model assembly: embeddings, stack, head, loss, serving steps.

Port of ``repro/models/lm.py``. ``build_model(cfg, rcfg)`` returns a
``Model`` with

  * ``defs`` / ``init`` / ``n_params`` — the parameter tree (nested dicts
    of tensors with the reference's keys),
  * ``forward(params, batch, mode=...)`` — logits, caches, aux loss,
  * ``loss_fn(params, batch)``            — train-mode forward + CE loss,
  * ``prefill(params, batch)``            — last-position logits + caches,
  * ``decode_step(params, batch, caches, position)`` — one token; the
    caches are updated in place,
  * ``cache_defs(batch, max_seq)``        — KV/state cache ParamDefs.

Batches: ``{"tokens": (B,S) int, "labels": (B,S), "mask": (B,S)}``. The
frontend-stub archs (VLM / audio ``embeds``) are a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_device

from .common import (ParamDef, Tree, apply_norm, init_params, norm_defs,
                     param_count)
from .config import ModelConfig, RunConfig
from .transformer import stack_apply, stack_cache_defs, stack_defs


def model_defs(cfg: ModelConfig, param_dtype: torch.dtype) -> Tree:
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"frontend {cfg.frontend!r} (precomputed embeds) is a later "
            "slice of the port (ROADMAP queue 1)")
    d: Dict[str, Tree] = {
        "embed": ParamDef((cfg.vocab, cfg.d_model), param_dtype,
                          init="embed"),
        "stack": stack_defs(cfg, param_dtype),
        "final_norm": norm_defs(cfg.norm, cfg.d_model, param_dtype),
    }
    if not cfg.tie_embeddings:
        d["lm_head"] = ParamDef((cfg.d_model, cfg.vocab), param_dtype,
                                init="embed")
    return d


def _embed(params: Tree, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
           rcfg: RunConfig) -> torch.Tensor:
    x = params["embed"][batch["tokens"].long()].to(rcfg.compute_dtype)
    if cfg.tie_embeddings:
        x = x * torch.sqrt(torch.tensor(float(cfg.d_model),
                                        dtype=rcfg.compute_dtype,
                                        device=x.device))
    return x


def _head(params: Tree, x: torch.Tensor, cfg: ModelConfig, rcfg: RunConfig,
          kernel: bool = False) -> torch.Tensor:
    x = apply_norm(cfg.norm, x, params["final_norm"], cfg.norm_eps,
                   kernel=kernel)
    if "lm_head" in params:
        return torch.matmul(x, params["lm_head"].to(rcfg.compute_dtype))
    return torch.matmul(x, params["embed"].to(rcfg.compute_dtype).t())


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor],
                 label_smoothing: float = 0.0
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean CE over masked tokens, f32. Returns (loss, n_tokens)."""
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

    # -- parameters ------------------------------------------------------
    def init(self, seed: int = 0, device="cuda") -> Tree:
        """Random parameters at the reference's init scales on ``device``
        (the card unless the caller asks for the CPU), drawn leaf after
        leaf from a generator on ``device`` seeded with ``seed``."""
        dev = resolve_device(device)
        return init_params(self.defs,
                           torch.Generator(device=dev).manual_seed(seed), dev)

    def n_params(self) -> int:
        return param_count(self.defs)

    # -- forward ---------------------------------------------------------
    def _run(self, params: Tree, batch: Dict[str, torch.Tensor], mode: str,
             caches: Optional[Tree], positions: Optional[torch.Tensor],
             last_only: bool):
        x = _embed(params, batch, self.cfg, self.rcfg)
        y, new_caches, aux = stack_apply(
            params["stack"], x, self.cfg, self.rcfg, mode=mode,
            positions=positions, caches=caches)
        if last_only:
            y = y[:, -1:]
        kernel = self.rcfg.use_pallas and mode in ("prefill", "decode")
        return _head(params, y, self.cfg, self.rcfg, kernel), new_caches, aux

    def forward(self, params: Tree, batch: Dict[str, torch.Tensor], *,
                mode: str = "train", caches: Optional[Tree] = None,
                positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[Tree], torch.Tensor]:
        """(logits (B,S,V), new caches or None, aux loss)."""
        return self._run(params, batch, mode, caches, positions, False)

    def loss_fn(self, params: Tree, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logits, _, aux = self.forward(params, batch, mode="train")
        loss, n = softmax_xent(logits, batch["labels"], batch.get("mask"),
                               self.rcfg.label_smoothing)
        total = loss + self.cfg.router_aux_coef * aux
        return total, {"ce_loss": loss, "aux_loss": aux, "tokens": n}

    # -- serving ---------------------------------------------------------
    def prefill(self, params: Tree, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Tree]:
        """(logits of the last position (B,V), caches). Only the last
        position leaves prefill, so the head runs on it alone (at 4 x 4096
        tokens and a 256k vocab the full logits would be 8.4 GB in bf16)."""
        logits, caches, _ = self._run(params, batch, "prefill", None, None,
                                      True)
        return logits[:, -1], caches

    def decode_step(self, params: Tree, batch: Dict[str, torch.Tensor],
                    caches: Tree, position) -> Tuple[torch.Tensor, Tree]:
        """One new token: batch['tokens'] (B,1), ``position`` its global
        index (int or 0-d tensor). ``caches`` is updated in place (the
        reference donates it) and returned."""
        tokens = batch["tokens"]
        pos = torch.as_tensor(position, device=tokens.device).reshape(1, 1)
        pos = pos.expand(tokens.shape[0], 1)
        logits, caches, _ = self._run(params, batch, "decode", caches, pos,
                                      False)
        return logits[:, -1], caches

    def cache_defs(self, batch: int, max_seq: int,
                   cache_dtype: torch.dtype = torch.bfloat16) -> Tree:
        return stack_cache_defs(self.cfg, batch, max_seq, cache_dtype)


def build_model(cfg: ModelConfig, rcfg: Optional[RunConfig] = None) -> Model:
    rcfg = rcfg or RunConfig()
    return Model(cfg=cfg, rcfg=rcfg, defs=model_defs(cfg, rcfg.param_dtype))
