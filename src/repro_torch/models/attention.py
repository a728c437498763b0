"""GQA attention for the train mode: projections, RoPE, dense causal core.

Port of ``repro/models/attention.py``'s train path (``attn_defs``,
``_expand_kv``, ``_causal_mask``, ``full_attention`` and
``attention_apply(mode="train")``). The decode, prefill, chunked and
sliding-window paths are not ported yet and raise. The attention matmuls
stay ``torch.matmul``/``einsum``, as the reference leaves them to XLA.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .common import apply_rope, dense
from .config import ModelConfig, RunConfig

NEG_INF = -1e30  # large-negative instead of -inf: keeps masked-all lanes finite


def _expand_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B,S,Hkv,dh) -> (B,S,Hkv*groups,dh) repeating each kv head."""
    if groups == 1:
        return k
    return torch.repeat_interleave(k, groups, dim=2)


def _causal_mask(sq: int, skv: int, offset: int, window: int,
                 device=None) -> torch.Tensor:
    """(sq, skv) bool mask: query i attends key j iff j <= i+offset and
    (window == 0 or j > i+offset-window)."""
    qi = torch.arange(sq, device=device)[:, None] + offset
    kj = torch.arange(skv, device=device)[None, :]
    m = kj <= qi
    if window > 0:
        m &= kj > qi - window
    return m


def full_attention(q, k, v, *, offset: int = 0, window: int = 0,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Dense causal attention. q (B,Sq,H,dh), k/v (B,Skv,H,dh)."""
    dh = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    mask = _causal_mask(q.shape[1], k.shape[1], offset, window,
                        device=q.device)
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


class Attention(nn.Module):
    """Attention sub-block; parameters ``wq``, ``wk``, ``wv``, ``wo`` (and
    ``bq``/``bk``/``bv`` with ``qkv_bias``) in (in, out) layout."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d, h, hk = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
        dh = cfg.resolved_head_dim
        self.cfg = cfg
        self.wq = nn.Parameter(torch.empty(d, h * dh))
        self.wk = nn.Parameter(torch.empty(d, hk * dh))
        self.wv = nn.Parameter(torch.empty(d, hk * dh))
        self.wo = nn.Parameter(torch.empty(h * dh, d))
        bias = cfg.qkv_bias
        self.bq = nn.Parameter(torch.zeros(h * dh)) if bias else None
        self.bk = nn.Parameter(torch.zeros(hk * dh)) if bias else None
        self.bv = nn.Parameter(torch.zeros(hk * dh)) if bias else None

    def forward(self, x: torch.Tensor, rcfg: RunConfig, *,
                mode: str = "train",
                positions: Optional[torch.Tensor] = None,
                dense_attn_max_seq: int = 8192) -> torch.Tensor:
        """x (B,S,D) -> (B,S,D)."""
        cfg = self.cfg
        b, s, _ = x.shape
        h, hk = cfg.n_heads, cfg.n_kv_heads
        dh = cfg.resolved_head_dim
        if mode != "train":
            raise ValueError(
                f"attention mode {mode!r} is not ported yet: prefill and "
                "decode come with the LM stack (slice G, ROADMAP queue 1)")
        if cfg.window > 0 and s > cfg.window:
            raise ValueError(
                "sliding-window attention is not ported yet (slice G, "
                "ROADMAP queue 1)")
        if s > dense_attn_max_seq:
            raise ValueError(
                f"sequence length {s} needs the chunked attention path, "
                "which is not ported yet (slice G, ROADMAP queue 1)")
        cd = rcfg.compute_dtype
        q = dense(x, self.wq, self.bq, cd).reshape(b, s, h, dh)
        k = dense(x, self.wk, self.bk, cd).reshape(b, s, hk, dh)
        v = dense(x, self.wv, self.bv, cd).reshape(b, s, hk, dh)
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :]
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        groups = h // hk
        out = full_attention(q, _expand_kv(k, groups), _expand_kv(v, groups),
                             window=cfg.window)
        return dense(out.reshape(b, s, h * dh), self.wo, None, cd)
