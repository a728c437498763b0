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

On a mesh (``RunConfig.mesh``) q and the expanded k, v are placed over
``model`` by heads, the projections by the reference's annotations, and
the attention itself runs per rank (``distributed.regions``; it is local
to a (batch row, head)): the plain route on each rank's (batch, heads)
block, K8's prefill on that block with the kv heads its q heads read,
and decode. Decode writes the new key into the slot's owner only and, with
``decode_seq_shard`` and a cache sequence the ``model`` dim divides,
is flash-decode: each rank's (m, l, o) over its KV-sequence shard, m
combined by an all-reduce max, l and o by all-reduce sums after the
exp(m - m_g) correction. Otherwise each rank decodes over the whole
cache.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed.regions import Region, block_offset, is_dtensor
from repro_torch.distributed.sharding import (DEFAULT_SERVE_RULES,
                                              placements_for, replicate,
                                              shard)
from repro_torch.kernels import ops

from .common import ParamDef, Tree, apply_rope, dense
from .config import ModelConfig, RunConfig

NEG_INF = -1e30  # large-negative instead of -inf: keeps masked-all lanes finite
# longest sequence whose (S, S) scores the plain route materializes
DENSE_ATTN_MAX_SEQ = 8192


def attn_defs(cfg: ModelConfig, param_dtype: torch.dtype) -> Tree:
    d, h, hk = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    dh = cfg.resolved_head_dim
    defs = {"wq": ParamDef((d, h * dh), param_dtype, ("embed", "heads")),
            "wk": ParamDef((d, hk * dh), param_dtype, ("embed", "kv_heads")),
            "wv": ParamDef((d, hk * dh), param_dtype, ("embed", "kv_heads")),
            "wo": ParamDef((h * dh, d), param_dtype, ("heads", "embed"))}
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((h * dh,), param_dtype, ("heads_act",),
                              init="zeros")
        defs["bk"] = ParamDef((hk * dh,), param_dtype, ("kv_heads_act",),
                              init="zeros")
        defs["bv"] = ParamDef((hk * dh,), param_dtype, ("kv_heads_act",),
                              init="zeros")
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


def _decode_partial(q, k, v, valid, scale: float, groups: int):
    """Partial decode statistics over a KV block: q (B,1,H,dh), k/v
    (B,Sl,Hkv,dh), valid (B,Sl) -> m (B,H), l (B,H), o (B,H,dh) in f32."""
    ke = _expand_kv(k, groups).float()
    ve = _expand_kv(v, groups).float()
    s = torch.einsum("bqhd,bkhd->bhk", q.float(), ke) * scale   # (B,H,Sl)
    s = torch.where(valid[:, None, :], s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(valid[:, None, :], p, 0.0)
    return m, p.sum(dim=-1), torch.einsum("bhk,bkhd->bhd", p, ve)


def decode_attention(q, k_cache, v_cache, valid, *, groups: int,
                     scale: Optional[float] = None, mesh=None, rules=None,
                     seq_shard: bool = True) -> torch.Tensor:
    """One-token attention against a cache (B,Smax,Hkv,dh); ``valid``
    (B,Smax) bool marks live slots (the caller keeps the ring-buffer and
    length semantics). Statistics in f32.

    With a mesh the cache's sequence dim is split over ``model`` when
    ``seq_shard`` and ``model`` divides Smax (flash-decode: partials
    combined by all-reduce max and sums), else each rank reads the whole
    cache; the batch is split over the data dims that divide it, else
    replicated. No gradient (serving)."""
    dh = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    if mesh is None:
        m, l, o = _decode_partial(q, k_cache, v_cache, valid, scale, groups)
        out = o / torch.clamp(l[..., None], min=1e-30)
        return out[:, None].to(q.dtype).reshape(q.shape)
    from torch.distributed.tensor import Replicate

    rules = rules if rules is not None else DEFAULT_SERVE_RULES
    qpl = placements_for(("batch", None, None, None), rules, mesh, q.shape)
    kvpl = placements_for(("batch", "kv_seq", None, None), rules, mesh,
                          k_cache.shape)
    if not seq_shard:
        kvpl = tuple(Replicate() if p.is_shard(1) else p for p in kvpl)
    seq = [n for n, p in zip(mesh.mesh_dim_names, kvpl) if p.is_shard(1)]
    r = Region.over(mesh, kvpl)
    ql = r.enter(q, qpl)
    kl, vl = r.enter(k_cache, kvpl), r.enter(v_cache, kvpl)
    m, l, o = _decode_partial(ql, kl, vl, r.enter(valid, kvpl), scale,
                              groups)
    if seq:
        m_g = m.clone()
        for n in seq:
            r.all_reduce(m_g, "max", n)
        corr = torch.exp(m - m_g)
        l = l * corr
        o = o * corr[..., None]
        for n in seq:
            r.all_reduce(l, "sum", n)
            r.all_reduce(o, "sum", n)
    out = o / torch.clamp(l[..., None], min=1e-30)
    return r.leave(out[:, None].to(ql.dtype).reshape(ql.shape), qpl)


def _attend(q, ke, ve, win: int) -> torch.Tensor:
    """The plain route's choice: sliding-window when ``win > 0`` and the
    sequence is longer, else dense up to ``DENSE_ATTN_MAX_SEQ``, else
    chunked. k and v expanded to q's heads."""
    s = q.shape[1]
    if win > 0 and s > win:
        return sliding_window_attention(q, ke, ve, window=win)
    if s <= DENSE_ATTN_MAX_SEQ:
        return full_attention(q, ke, ve, window=win)
    return chunked_attention(q, ke, ve, window=win)


def _kernel_attention(q, k, v, window: int) -> torch.Tensor:
    """K8 on the model's (B,S,H,dh) layout, kv heads unexpanded."""
    out = ops.flash_attention(q.transpose(1, 2).contiguous(),
                              k.transpose(1, 2).contiguous(),
                              v.transpose(1, 2).contiguous(), window=window)
    return out.transpose(1, 2)


def _kv_for_heads(k, v, start: int, n: int, groups: int):
    """The kv heads that q heads [start, start + n) read (q head i reads kv
    head i // groups), as a GQA pair for K8: a slice when the heads' block
    is whole groups or within one group, else expanded and sliced."""
    hk = k.shape[2]
    if start == 0 and n == hk * groups:
        return k, v
    first, last = start // groups, (start + n - 1) // groups
    if (start % groups == 0 and n % groups == 0) or first == last:
        return k[:, :, first:last + 1], v[:, :, first:last + 1]
    return (_expand_kv(k, groups)[:, :, start:start + n],
            _expand_kv(v, groups)[:, :, start:start + n])


def _kernel_attention_sharded(q, k, v, window: int, groups: int,
                              rcfg: RunConfig):
    """K8 per rank on a mesh: its (batch, q heads) block of q and the kv
    heads those read; attention is local to a (batch row, head), so no
    collective."""
    mesh, rules = rcfg.mesh, rcfg.rules
    qpl = placements_for(("batch", "seq", "heads_act", None), rules, mesh,
                         q.shape)
    kvpl = placements_for(("batch", "seq", None, None), rules, mesh,
                          k.shape)
    r = Region.over(mesh, qpl)
    ql = r.enter(q, qpl)
    n = ql.shape[2]
    kl, vl = _kv_for_heads(r.enter(k, kvpl), r.enter(v, kvpl),
                           block_offset(r, qpl, 2, n), n, groups)
    return r.leave(_kernel_attention(ql, kl, vl, window), qpl)


def _prefill_cache(k: torch.Tensor, slots: int, win: int,
                   rcfg: RunConfig) -> torch.Tensor:
    """The prefill's (B, slots, Hkv, dh) cache of k (a ring buffer of
    ``slots`` for windowed attention, the key at global position t in slot
    t % slots), placed by the cache's logical axes on a mesh."""
    mesh, rules = rcfg.mesh, rcfg.rules
    if mesh is not None:   # pad and roll on each rank's batch block
        pl = placements_for(("batch", None, None, None), rules, mesh,
                            k.shape)
        r = Region.over(mesh, pl)
        kc = r.leave(_prefill_cache(r.enter(k, pl), slots, win,
                                    rcfg.with_(mesh=None)), pl)
        return shard(kc, ("batch", "kv_seq", None, None), rules, mesh)
    s = k.shape[1]
    if win > 0 and s >= slots:
        return torch.roll(k[:, -slots:], s % slots, dims=1).contiguous()
    return torch.nn.functional.pad(k, (0, 0, 0, 0, 0, slots - s)) \
        .contiguous()


def _write_slot(cache: torch.Tensor, widx: torch.Tensor,
                new: torch.Tensor, rcfg: RunConfig) -> None:
    """cache[:, widx] = new, in place. On a mesh only the rank whose
    KV-sequence block holds slot ``widx`` changes it: the others write
    their slot back to itself (no host read of ``widx``)."""
    if rcfg.mesh is None:
        cache.index_copy_(1, widx, new.to(cache.dtype))
        return
    from torch.distributed.tensor import Replicate

    pl = cache.placements
    r = Region.over(rcfg.mesh, pl)
    loc = cache.to_local()
    sl = loc.shape[1]
    nl = r.enter(new, tuple(p if p.is_shard(0) else Replicate()
                            for p in pl))
    idx = widx - block_offset(r, pl, 1, sl)
    mine = (idx >= 0) & (idx < sl)
    idx = torch.clamp(idx, 0, sl - 1)
    val = torch.where(mine, nl.to(loc.dtype), loc.index_select(1, idx))
    loc.index_copy_(1, idx, val)


def _place_heads(x: torch.Tensor, logical: str, heads: int, rcfg: RunConfig
                 ) -> torch.Tensor:
    """The (B, S, heads·dh) projection ``x`` placed by ``logical`` as the
    (B, S, heads) it splits into: a mesh dim shards it only where it
    divides the heads, so that the head split never cuts a head (40 heads
    on a 16-way ``model`` dim stay whole, replicated)."""
    mesh = rcfg.mesh
    if mesh is None:
        return x
    pl = placements_for(("batch", "seq", logical), rcfg.rules, mesh,
                        (x.shape[0], x.shape[1], heads))
    if not is_dtensor(x):
        x = replicate(x, mesh)
    return x if tuple(x.placements) == pl else x.redistribute(mesh, pl)


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
    mesh, rules = rcfg.mesh, rcfg.rules

    # placed before the head split, so that no mesh dim splits a head
    q = _place_heads(dense(x, p["wq"], p.get("bq"), cd), "heads_act", h,
                     rcfg).reshape(b, s, h, dh)
    k = _place_heads(dense(x, p["wk"], p.get("bk"), cd), "kv_heads_act", hk,
                     rcfg).reshape(b, s, hk, dh)
    v = _place_heads(dense(x, p["wv"], p.get("bv"), cd), "kv_heads_act", hk,
                     rcfg).reshape(b, s, hk, dh)
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = shard(q, ("batch", "seq", "heads_act", None), rules, mesh)
    k = shard(k, ("batch", "seq", "kv_heads_act", None), rules, mesh)
    v = shard(v, ("batch", "seq", "kv_heads_act", None), rules, mesh)

    new_cache = None
    if mode == "decode":
        if cache is None or s != 1:
            raise ValueError(
                "attention decode mode needs a cache (from mode='prefill') "
                f"and a single-token input; got cache={cache is not None}, "
                f"seq_len={s}")
        clen = cache["len"]                   # global position counter
        if mesh is not None:
            clen = clen.to_local()
        slots = cache["k"].shape[1]
        # ring-buffer write for windowed caches; plain append otherwise
        # (clamped to the last slot, as dynamic_update_slice clamps)
        widx = clen % slots if win > 0 else torch.clamp(clen, max=slots - 1)
        widx = widx.reshape(1).long()
        _write_slot(cache["k"], widx, k, rcfg)
        _write_slot(cache["v"], widx, v, rcfg)
        valid = torch.arange(slots, device=x.device)[None, :] \
            < torch.clamp(clen + 1, max=slots)
        out = decode_attention(q, cache["k"], cache["v"],
                               valid.expand(b, slots), groups=groups,
                               mesh=mesh, rules=rules,
                               seq_shard=rcfg.decode_seq_shard)
        clen.add_(1)
        new_cache = cache
    else:
        if rcfg.use_pallas and mode == "prefill":
            out = (_kernel_attention(q, k, v, win) if mesh is None else
                   _kernel_attention_sharded(q, k, v, win, groups, rcfg))
        else:
            ke = _expand_kv(k, groups)
            ve = _expand_kv(v, groups)
            if mesh is None:
                out = _attend(q, ke, ve, win)
            else:   # local to a (batch row, head): each rank its block
                heads = ("batch", "seq", "heads_act", None)
                ke = shard(ke, heads, rules, mesh)
                ve = shard(ve, heads, rules, mesh)
                pl = placements_for(heads, rules, mesh, q.shape)
                r = Region.over(mesh, pl)
                out = r.leave(_attend(r.enter(q, pl), r.enter(ke, pl),
                                      r.enter(ve, pl), win), pl)
        if mode == "prefill":
            slots = rcfg.max_seq if win == 0 else min(rcfg.max_seq, win)
            slots = max(slots, s if win == 0 else min(s, win))
            length = torch.tensor(s, dtype=torch.int32, device=x.device)
            new_cache = {"k": _prefill_cache(k, slots, win, rcfg),
                         "v": _prefill_cache(v, slots, win, rcfg),
                         "len": shard(length, (), rules, mesh)}

    out = shard(out, ("batch", "seq", "heads_act", None), rules, mesh)
    y = dense(out.reshape(b, s, h * dh), p["wo"], None, cd)
    return shard(y, ("batch", "res_seq", "embed_act"), rules, mesh), \
        new_cache
