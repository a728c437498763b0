"""Mamba-2 block: state-space duality (SSD) with the chunked scan.

Port of ``repro/models/mamba2.py``. The selective SSM

    h_t = exp(dt_t·A) h_{t-1} + dt_t·(B_t ⊗ x_t),   y_t = C_t·h_t + D⊙x_t

runs with the SSD chunked algorithm (Dao & Gu 2024): the sequence is cut
into chunks of Q steps; inside a chunk the output is a masked
(1-semiseparable) attention-like product ((C Bᵀ) ⊙ L)(dt ⊙ X), and the
(P, N) state carries from chunk to chunk — the chunk boundaries are the
trajectory checkpoints of the paper's idea.

``ssd_chunked`` is the plain f32 route; it lives in ``kernels.ssd_scan``
beside K9, whose plain version it is. Under ``RunConfig.use_pallas``
prefill runs the scan through K9 (``kernels.ops.ssd_scan``), which writes
y in x's dtype and the final state in f32; both RMSNorms of the block run
through K7 in prefill and decode. Decode is the one-step recurrence on the carried (B, H, P, N)
state, plain, and updates the cache in place.

On a mesh the heads split over ``model`` (u's channels, dt, A, D, the
conv weight and the ssm state alike; B, C and the conv state whole) and
the batch over the data dims: ``_mix_sharded`` runs the conv, the scan
(K9 on each rank's heads; its sequence dim is never split) and the skip
per rank, the projections and the gated norm stay DTensor ops (K7 takes
the gated rows gathered whole).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_chunked

from repro_torch.distributed.regions import Region, block_offset
from repro_torch.distributed.sharding import placements_for, shard

from .common import ParamDef, Tree, dense, kernel_rmsnorm, rmsnorm
from .config import ModelConfig, RunConfig
from .rglru import causal_conv1d, conv_tail


def mamba2_defs(cfg: ModelConfig, param_dtype: torch.dtype) -> Tree:
    d, di = cfg.d_model, cfg.d_inner
    h, n, g = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_ngroups
    return {
        "w_z": ParamDef((d, di), param_dtype, ("embed", "mlp")),
        "w_x": ParamDef((d, di), param_dtype, ("embed", "mlp")),
        "w_b": ParamDef((d, g * n), param_dtype, ("embed", None)),
        "w_c": ParamDef((d, g * n), param_dtype, ("embed", None)),
        "w_dt": ParamDef((d, h), param_dtype, ("embed", None)),
        # f32 whatever the param dtype
        "dt_bias": ParamDef((h,), torch.float32, (None,), init="zeros"),
        "a_log": ParamDef((h,), torch.float32, (None,), init="uniform_ssm"),
        "d_skip": ParamDef((h,), torch.float32, (None,), init="ones"),
        "conv_x": ParamDef((cfg.ssm_conv, di), param_dtype,
                           ("conv", "mlp_act")),
        "conv_b": ParamDef((cfg.ssm_conv, g * n), param_dtype,
                           ("conv", None)),
        "conv_c": ParamDef((cfg.ssm_conv, g * n), param_dtype,
                           ("conv", None)),
        "norm": ParamDef((di,), param_dtype, ("mlp_act",), init="ones"),
        "w_out": ParamDef((di, d), param_dtype, ("mlp", "embed")),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as logaddexp(x, 0) (torch's
    ``F.softplus`` switches to x above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def ssd_decode_step(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b_vec: torch.Tensor, c_vec: torch.Tensor,
                    state: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token SSM update. x (B,H,P), dt (B,H) f32, a (H,), b_vec/c_vec
    (B,G,N), state (B,H,P,N) f32. Returns (y (B,H,P), new_state)."""
    h, g = x.shape[1], b_vec.shape[1]
    rep = h // g
    bf = torch.repeat_interleave(b_vec.float(), rep, dim=1)     # (B,H,N)
    cf = torch.repeat_interleave(c_vec.float(), rep, dim=1)
    da = torch.exp(dt * a[None])                                 # (B,H)
    new_state = state * da[..., None, None] + torch.einsum(
        "bhn,bh,bhp->bhpn", bf, dt, x.float())
    y = torch.einsum("bhn,bhpn->bhp", cf, new_state)
    return y, new_state


def _ssm_mix(u, bm, cm, dt, a, d_skip, conv_x, conv_b, conv_c, cache,
             mode: str, kernel: bool, cfg: ModelConfig, u_row=None,
             off: int = 0):
    """The block's sequence mixing on a block of heads: conv, SiLU, the
    SSD scan (K9 under ``kernel`` in prefill) or the decode step, the D
    skip, and the cache. u (B,S,Hl·P) with its conv weight (Hl of the
    heads), bm/cm (B,S,G·N), dt (B,S,Hl) f32, a/d_skip (Hl,). ``cache`` is
    the (conv (B,W-1,Di+2·G·N), ssm (B,Hl,P,N)) pair of plain tensors or
    None; u's channels start at ``off`` of the conv state's u part, whose
    new input is ``u_row`` (default u: all of the channels). Returns (y
    (B,S,Hl·P) f32 or x's dtype, the new cache: ``cache`` updated in place
    in decode, a fresh pair in prefill, None in train)."""
    bsz, s, di = u.shape
    pp, nn, g = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_ngroups
    hh = di // pp
    u_row = u if u_row is None else u_row
    ssm_state = cache[1] if cache is not None else None
    if mode == "decode":
        cs = cache[0]
        dw, gn = u_row.shape[-1], bm.shape[-1]
        u_st, b_st, c_st = (cs[..., off:off + di], cs[..., dw:dw + gn],
                            cs[..., dw + gn:])
        u2 = causal_conv1d(u, conv_x, state=u_st)
        bm2 = causal_conv1d(bm, conv_b, state=b_st)
        cm2 = causal_conv1d(cm, conv_c, state=c_st)
        u2, bm2, cm2 = (F.silu(t) for t in (u2, bm2, cm2))
        y1, h_out = ssd_decode_step(
            u2[:, 0].reshape(bsz, hh, pp), dt[:, 0], a,
            bm2[:, 0].reshape(bsz, g, nn), cm2[:, 0].reshape(bsz, g, nn),
            ssm_state)
        y = y1[:, None]
    else:
        u2 = F.silu(causal_conv1d(u, conv_x))
        bm2 = F.silu(causal_conv1d(bm, conv_b))
        cm2 = F.silu(causal_conv1d(cm, conv_c))
        # pad S to a chunk multiple (dt = 0 padding is state-neutral)
        q = cfg.ssm_chunk
        pad = (-s) % q
        if pad:
            u2p, bm2p, cm2p, dtp = (F.pad(t, (0,) * (2 * (t.dim() - 2))
                                          + (0, pad))
                                    for t in (u2, bm2, cm2, dt))
        else:
            u2p, bm2p, cm2p, dtp = u2, bm2, cm2, dt
        sp = s + pad
        scan = ops.ssd_scan if kernel and mode == "prefill" else ssd_chunked
        y, h_out = scan(
            u2p.reshape(bsz, sp, hh, pp), dtp, a,
            bm2p.reshape(bsz, sp, g, nn), cm2p.reshape(bsz, sp, g, nn),
            q, h0=ssm_state)
        y = y[:, :s]
    y = y + (u2.reshape(bsz, s, hh, pp).float()
             * d_skip[None, None, :, None]).to(y.dtype)
    y = y.reshape(bsz, s, hh * pp)
    if mode == "train":
        return y, None
    row = torch.cat([u_row, bm, cm], dim=-1)
    w = conv_x.shape[0]
    if mode == "decode":
        if w > 1:
            cs.copy_(torch.cat([cs[:, 1:], row.to(cs.dtype)], dim=1))
        cache[1].copy_(h_out)
        return y, cache
    return y, (conv_tail(row, w).float(), h_out)


def _mix_sharded(p, u, bm, cm, dt, a, cache, mode: str, kernel: bool,
                 cfg: ModelConfig, rcfg: RunConfig):
    """``_ssm_mix`` per rank on a mesh: each ``model`` rank runs its block
    of heads (u's channels, dt, A, D, the conv weight and the ssm state
    split alike; B and C whole), each data rank its batch rows. The conv
    state is replicated over ``model`` as the reference's cache spec has
    it, so its new row takes u gathered whole. Returns (y as a DTensor,
    the prefill's new (conv, ssm) pair as DTensors, else None)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, rules = rcfg.mesh, rcfg.rules
    act = placements_for(("batch", "seq", "mlp_act"), rules, mesh, u.shape)
    heads = placements_for(("batch", "seq", "heads_act"), rules, mesh,
                           dt.shape)
    if any(x.is_shard(1) for x in act + heads):
        raise ValueError(
            "mamba2 on a mesh: the SSD scan runs each rank's heads along "
            "the whole sequence; rules that shard 'seq' are not supported")
    if any(x.is_shard(2) != y.is_shard(2) for x, y in zip(act, heads)):
        # channels and heads would split differently: keep both whole
        act = tuple(Replicate() if x.is_shard(2) else x for x in act)
        heads = tuple(Replicate() if x.is_shard(2) else x for x in heads)
    whole = tuple(Replicate() if x.is_shard(2) else x for x in act)
    per_head = tuple(Shard(0) if x.is_shard(2) else Replicate()
                     for x in heads)
    per_chan = tuple(Shard(1) if x.is_shard(2) else Replicate()
                     for x in act)
    rep = tuple(Replicate() for _ in act)
    r = Region.over(mesh, act)
    ul, bml, cml = r.enter(u, act), r.enter(bm, whole), r.enter(cm, whole)
    dtl = r.enter(dt, heads)
    al, dl = r.enter(a, per_head), r.enter(p["d_skip"], per_head)
    cx = r.enter(p["conv_x"], per_chan)
    cb, cc = r.enter(p["conv_b"], rep), r.enter(p["conv_c"], rep)
    local = None if cache is None else (cache["conv"].to_local(),
                                        cache["ssm"].to_local())
    u_all = None if mode == "train" else r.enter(u, whole)
    yl, new = _ssm_mix(ul, bml, cml, dtl, al, dl, cx, cb, cc, local, mode,
                       kernel, cfg, u_row=u_all,
                       off=block_offset(r, act, 2, ul.shape[-1]))
    y = r.leave(yl, act)
    if mode != "prefill":
        return y, None
    ssm_pl = tuple(Shard(1) if x.is_shard(2) else x for x in heads)
    return y, (r.leave(new[0], whole), r.leave(new[1], ssm_pl))


def mamba2_block_apply(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    cfg: ModelConfig,
    rcfg: RunConfig,
    *,
    mode: str = "train",
    cache: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Mamba-2 block. x (B,S,D) -> (y (B,S,D), new_cache).

    ``decode`` updates ``cache`` (conv and ssm states) in place, where the
    reference's engine donates it, and returns it."""
    cd = rcfg.compute_dtype
    mesh, rules = rcfg.mesh, rcfg.rules
    s = x.shape[1]
    kernel = rcfg.use_pallas and mode in ("prefill", "decode")
    if mode == "decode" and (cache is None or s != 1):
        raise ValueError(
            "mamba2 decode mode needs a cache (from mode='prefill') "
            f"and a single-token input; got cache={cache is not None}, "
            f"seq_len={s}")

    z = dense(x, p["w_z"], None, cd)
    u = dense(x, p["w_x"], None, cd)
    u = shard(u, ("batch", "seq", "mlp_act"), rules, mesh)
    bm = dense(x, p["w_b"], None, cd)
    cm = dense(x, p["w_c"], None, cd)
    dt_raw = dense(x, p["w_dt"], None, cd).float()
    dt = softplus(dt_raw + p["dt_bias"][None, None])
    a = -torch.exp(p["a_log"])

    if mesh is not None:
        y, new = _mix_sharded(p, u, bm, cm, dt, a, cache, mode, kernel,
                              cfg, rcfg)
    else:
        y, new = _ssm_mix(u, bm, cm, dt, a, p["d_skip"], p["conv_x"],
                          p["conv_b"], p["conv_c"],
                          None if cache is None else (cache["conv"],
                                                      cache["ssm"]),
                          mode, kernel, cfg)
    new_cache = {"conv": new[0], "ssm": new[1]} if mode == "prefill" \
        else cache if mode == "decode" else None

    y = shard(y.to(cd), ("batch", "seq", "mlp_act"), rules, mesh)
    gated = y * F.silu(z)
    y = kernel_rmsnorm(gated, p["norm"]) if kernel \
        else rmsnorm(gated, p["norm"])
    out = dense(y, p["w_out"], None, cd)
    return shard(out, ("batch", "res_seq", "embed_act"), rules, mesh), \
        new_cache


def mamba2_cache_defs(cfg: ModelConfig, batch: int) -> Tree:
    di = cfg.d_inner
    gn = cfg.ssm_ngroups * cfg.ssm_state
    return {
        "conv": ParamDef((batch, cfg.ssm_conv - 1, di + 2 * gn),
                         torch.float32, ("batch", None, None), init="zeros"),
        "ssm": ParamDef((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                         cfg.ssm_state), torch.float32,
                        ("batch", "heads_act", None, None), init="zeros"),
    }
