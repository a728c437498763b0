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
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.ssd_scan import ssd_chunked

from .common import ParamDef, Tree, dense, rmsnorm
from .config import ModelConfig, RunConfig
from .rglru import causal_conv1d, conv_tail


def mamba2_defs(cfg: ModelConfig, param_dtype: torch.dtype) -> Tree:
    d, di = cfg.d_model, cfg.d_inner
    h, n, g = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_ngroups
    return {
        "w_z": ParamDef((d, di), param_dtype),
        "w_x": ParamDef((d, di), param_dtype),
        "w_b": ParamDef((d, g * n), param_dtype),
        "w_c": ParamDef((d, g * n), param_dtype),
        "w_dt": ParamDef((d, h), param_dtype),
        # f32 whatever the param dtype
        "dt_bias": ParamDef((h,), torch.float32, init="zeros"),
        "a_log": ParamDef((h,), torch.float32, init="uniform_ssm"),
        "d_skip": ParamDef((h,), torch.float32, init="ones"),
        "conv_x": ParamDef((cfg.ssm_conv, di), param_dtype),
        "conv_b": ParamDef((cfg.ssm_conv, g * n), param_dtype),
        "conv_c": ParamDef((cfg.ssm_conv, g * n), param_dtype),
        "norm": ParamDef((di,), param_dtype, init="ones"),
        "w_out": ParamDef((di, d), param_dtype),
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
    bsz, s, _ = x.shape
    hh, pp, nn = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    g = cfg.ssm_ngroups
    kernel = rcfg.use_pallas and mode in ("prefill", "decode")

    z = dense(x, p["w_z"], None, cd)
    u = dense(x, p["w_x"], None, cd)
    bm = dense(x, p["w_b"], None, cd)
    cm = dense(x, p["w_c"], None, cd)
    dt_raw = dense(x, p["w_dt"], None, cd).float()
    dt = softplus(dt_raw + p["dt_bias"][None, None])
    a = -torch.exp(p["a_log"])

    new_cache = None
    if mode == "decode":
        if cache is None or s != 1:
            raise ValueError(
                "mamba2 decode mode needs a cache (from mode='prefill') "
                f"and a single-token input; got cache={cache is not None}, "
                f"seq_len={s}")
        w = p["conv_x"].shape[0]
        cs = cache["conv"]                   # (B, W-1, di + 2gn)
        di = u.shape[-1]
        cat = torch.cat([u, bm, cm], dim=-1)
        u2 = causal_conv1d(u, p["conv_x"], state=cs[..., :di])
        bm2 = causal_conv1d(bm, p["conv_b"], state=cs[..., di:di + g * nn])
        cm2 = causal_conv1d(cm, p["conv_c"], state=cs[..., di + g * nn:])
        u2, bm2, cm2 = (F.silu(t) for t in (u2, bm2, cm2))
        y1, st = ssd_decode_step(
            u2[:, 0].reshape(bsz, hh, pp), dt[:, 0], a,
            bm2[:, 0].reshape(bsz, g, nn), cm2[:, 0].reshape(bsz, g, nn),
            cache["ssm"])
        y = y1[:, None]
        if w > 1:
            cs.copy_(torch.cat([cs[:, 1:], cat.to(cs.dtype)], dim=1))
        cache["ssm"].copy_(st)
        new_cache = cache
    else:
        u2 = F.silu(causal_conv1d(u, p["conv_x"]))
        bm2 = F.silu(causal_conv1d(bm, p["conv_b"]))
        cm2 = F.silu(causal_conv1d(cm, p["conv_c"]))
        h0 = cache["ssm"] if cache is not None else None
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
        y, h_last = scan(
            u2p.reshape(bsz, sp, hh, pp), dtp, a,
            bm2p.reshape(bsz, sp, g, nn), cm2p.reshape(bsz, sp, g, nn),
            q, h0=h0)
        y = y[:, :s]
        if mode == "prefill":
            w = p["conv_x"].shape[0]
            cat = torch.cat([u, bm, cm], dim=-1)
            new_cache = {"conv": conv_tail(cat, w).float(), "ssm": h_last}

    y = y + (u2.reshape(bsz, s, hh, pp).float()
             * p["d_skip"][None, None, :, None]).to(y.dtype)
    y = y.reshape(bsz, s, hh * pp).to(cd)
    gated = y * F.silu(z)
    y = ops.rmsnorm(gated, p["norm"]) if kernel \
        else rmsnorm(gated, p["norm"])
    return dense(y, p["w_out"], None, cd), new_cache


def mamba2_cache_defs(cfg: ModelConfig, batch: int) -> Tree:
    di = cfg.d_inner
    gn = cfg.ssm_ngroups * cfg.ssm_state
    return {
        "conv": ParamDef((batch, cfg.ssm_conv - 1, di + 2 * gn),
                         torch.float32, init="zeros"),
        "ssm": ParamDef((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                         cfg.ssm_state), torch.float32, init="zeros"),
    }
