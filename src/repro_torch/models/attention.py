"""GQA attention: training, sliding-window and chunked prefill, decode.

Port of ``repro/models/attention.py`` without the mesh (``attn_defs``,
``_expand_kv``, ``_causal_mask``, ``full_attention``,
``chunked_attention``, ``sliding_window_attention``, ``decode_attention``
and ``attention_apply`` for ``train``/``prefill``/``decode``). The
reference's route choice is kept for the plain route: sliding-window when
``window > 0 and s > window`` (itself banded ``full_attention`` when
``s % window != 0``), else dense up to ``DENSE_ATTN_MAX_SEQ``, else
chunked. Under ``RunConfig.use_pallas`` every prefill goes to K8
(``kernels.ops.flash_attention``, native GQA, any length); decode stays
plain, as the reference has no decode kernel. The attention matmuls of
the plain route stay ``torch.einsum``, as the reference leaves them to
XLA.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops

from .common import ParamDef, Tree, apply_rope, dense
from .config import ModelConfig, RunConfig

NEG_INF = -1e30  # large-negative instead of -inf: keeps masked-all lanes finite
# longest sequence whose (S, S) scores the plain route materializes
DENSE_ATTN_MAX_SEQ = 8192


def attn_defs(cfg: ModelConfig, param_dtype: torch.dtype) -> Tree:
    d, h, hk = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    dh = cfg.resolved_head_dim
    defs = {"wq": ParamDef((d, h * dh), param_dtype),
            "wk": ParamDef((d, hk * dh), param_dtype),
            "wv": ParamDef((d, hk * dh), param_dtype),
            "wo": ParamDef((h * dh, d), param_dtype)}
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((h * dh,), param_dtype, init="zeros")
        defs["bk"] = ParamDef((hk * dh,), param_dtype, init="zeros")
        defs["bv"] = ParamDef((hk * dh,), param_dtype, init="zeros")
    return defs


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


def chunked_attention(q, k, v, *, window: int = 0, block: int = 1024,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Causal flash-style attention: a loop over KV blocks with running
    (max, sum, out) statistics in f32; the output of ``full_attention``
    (same-seq case, offset 0)."""
    b, sq, h, dh = q.shape
    skv = k.shape[1]
    if skv % block != 0:
        raise ValueError(
            f"attention: kv sequence length {skv} not divisible by "
            f"block {block}")
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qf = q.float() * scale
    m = torch.full((b, h, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, h, sq), device=q.device)
    o = torch.zeros((b, h, sq, dh), device=q.device)
    qi = torch.arange(sq, device=q.device)
    for j in range(skv // block):
        kj = k[:, j * block:(j + 1) * block].float()
        vj = v[:, j * block:(j + 1) * block].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kj)
        kpos = j * block + torch.arange(block, device=q.device)
        mask = kpos[None, :] <= qi[:, None]
        if window > 0:
            mask &= kpos[None, :] > qi[:, None] - window
        s = torch.where(mask[None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vj)
        m = m_new
    out = o / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)            # (B,Sq,H,dh)


def sliding_window_attention(q, k, v, *, window: int,
                             scale: Optional[float] = None) -> torch.Tensor:
    """Banded attention via same-chunk + previous-chunk blocks: memory
    O(S·2w) instead of O(S²). Requires S % window == 0 (else the dense
    banded fallback)."""
    b, s, h, dh = q.shape
    if s <= window or s % window != 0:
        return full_attention(q, k, v, window=window, scale=scale)
    nc = s // window
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qc = q.reshape(b, nc, window, h, dh)
    kc = k.reshape(b, nc, window, h, dh)
    vc = v.reshape(b, nc, window, h, dh)
    # previous chunk (zeros before chunk 0)
    kp = torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], dim=1)
    vp = torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], dim=1)
    k2 = torch.cat([kp, kc], dim=2)                    # (B,nc,2w,H,dh)
    v2 = torch.cat([vp, vc], dim=2)
    sc = torch.einsum("bcqhd,bckhd->bchqk", qc, k2).float() * scale
    # positions within the 2w key window: query i (0..w-1) at global w+i
    qi = torch.arange(window, device=q.device)[:, None] + window
    kj = torch.arange(2 * window, device=q.device)[None, :]
    mask = (kj <= qi) & (kj > qi - window)
    first = torch.arange(nc, device=q.device) == 0     # chunk 0: no prev
    mask = mask[None] & ~(first[:, None, None] & (kj < window)[None])
    sc = torch.where(mask[None, :, None], sc, NEG_INF)
    p = torch.softmax(sc, dim=-1).to(q.dtype)
    out = torch.einsum("bchqk,bckhd->bcqhd", p, v2)
    return out.reshape(b, s, h, dh)


def decode_attention(q, k_cache, v_cache, valid, *, groups: int,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One-token attention against a cache (B,Smax,Hkv,dh); ``valid``
    (B,Smax) bool marks live slots (the caller keeps the ring-buffer and
    length semantics). Statistics in f32."""
    dh = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    ke = _expand_kv(k_cache, groups).float()
    ve = _expand_kv(v_cache, groups).float()
    s = torch.einsum("bqhd,bkhd->bhk", q.float(), ke) * scale   # (B,H,Sl)
    s = torch.where(valid[:, None, :], s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(valid[:, None, :], p, 0.0)
    l = p.sum(dim=-1)
    o = torch.einsum("bhk,bkhd->bhd", p, ve)
    out = o / torch.clamp(l[..., None], min=1e-30)
    return out[:, None].to(q.dtype).reshape(q.shape)


def _kernel_attention(q, k, v, window: int) -> torch.Tensor:
    """K8 on the model's (B,S,H,dh) layout, kv heads unexpanded."""
    out = ops.flash_attention(q.transpose(1, 2).contiguous(),
                              k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous(), window=window)
    return out.transpose(1, 2)


def attention_apply(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    cfg: ModelConfig,
    rcfg: RunConfig,
    *,
    mode: str,                            # train | prefill | decode
    positions: Optional[torch.Tensor] = None,
    cache: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full attention sub-block. x (B,S,D) -> (y (B,S,D), new_cache).

    ``prefill`` returns a fixed-capacity cache (a ring buffer of
    ``min(max_seq, window)`` slots for windowed attention, the key at
    global position t in slot t % slots). ``decode`` writes the new key
    and value into the given cache *in place* (where the reference's
    engine donates it) and returns that cache with ``len`` advanced.
    """
    b, s, _ = x.shape
    h, hk = cfg.n_heads, cfg.n_kv_heads
    dh = cfg.resolved_head_dim
    groups = h // hk
    win = cfg.window
    cd = rcfg.compute_dtype

    q = dense(x, p["wq"], p.get("bq"), cd).reshape(b, s, h, dh)
    k = dense(x, p["wk"], p.get("bk"), cd).reshape(b, s, hk, dh)
    v = dense(x, p["wv"], p.get("bv"), cd).reshape(b, s, hk, dh)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if mode == "decode":
        if cache is None or s != 1:
            raise ValueError(
                "attention decode mode needs a cache (from mode='prefill') "
                f"and a single-token input; got cache={cache is not None}, "
                f"seq_len={s}")
        clen = cache["len"]                   # global position counter
        slots = cache["k"].shape[1]
        # ring-buffer write for windowed caches; plain append otherwise
        # (clamped to the last slot, as dynamic_update_slice clamps)
        widx = clen % slots if win > 0 else torch.clamp(clen, max=slots - 1)
        widx = widx.reshape(1).long()
        cache["k"].index_copy_(1, widx, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, widx, v.to(cache["v"].dtype))
        valid = torch.arange(slots, device=x.device)[None, :] \
            < torch.clamp(clen + 1, max=slots)
        out = decode_attention(q, cache["k"], cache["v"],
                               valid.expand(b, slots), groups=groups)
        cache["len"].add_(1)
        new_cache = cache
    else:
        if rcfg.use_pallas and mode == "prefill":
            out = _kernel_attention(q, k, v, win)
        else:
            ke = _expand_kv(k, groups)
            ve = _expand_kv(v, groups)
            if win > 0 and s > win:
                out = sliding_window_attention(q, ke, ve, window=win)
            elif s <= DENSE_ATTN_MAX_SEQ:
                out = full_attention(q, ke, ve, window=win)
            else:
                out = chunked_attention(q, ke, ve, window=win)
        if mode == "prefill":
            slots = rcfg.max_seq if win == 0 else min(rcfg.max_seq, win)
            slots = max(slots, s if win == 0 else min(s, win))
            if win > 0 and s >= slots:
                # key at global position t lives in slot t % slots
                kk = torch.roll(k[:, -slots:], s % slots, dims=1)
                vv = torch.roll(v[:, -slots:], s % slots, dims=1)
            else:
                pad = (0, 0, 0, 0, 0, slots - s)
                kk = torch.nn.functional.pad(k, pad)
                vv = torch.nn.functional.pad(v, pad)
            new_cache = {"k": kk.contiguous(), "v": vv.contiguous(),
                         "len": torch.tensor(s, dtype=torch.int32,
                                             device=x.device)}

    y = dense(out.reshape(b, s, h * dh), p["wo"], None, cd)
    return y, new_cache
