"""RG-LRU recurrent block (Griffin / RecurrentGemma).

Port of ``repro/models/rglru.py``. The Real-Gated Linear Recurrent Unit
is a gated leaky integrator

    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ x_t),
    a_t = exp(-c · softplus(Λ) · r_t),     r_t, i_t = σ(block-diag gates)

— a zero-order-hold discretized diagonal linear ODE. Block structure:
``y = W_out(GeLU(W_gate x) ⊙ RG-LRU(conv1d_4(W_x x)))``, the gates
block-diagonal with 16 blocks and computed in f32.

Train and prefill scan the whole sequence: the plain route is the
doubling scan ``kernels.rg_lru.rg_lru_plain`` (the reference's
associative-scan algorithm); under ``RunConfig.use_pallas`` prefill calls
K10 (``kernels.ops.rg_lru``) on the same ``log_a`` and ``b``. Decode is
the one-step recurrence over the carried state, plain, and updates the
cache in place.

On a mesh the recurrence's channels split over ``model`` with the gates'
diagonal blocks (``mlp``): conv, gates, scan (K10 on each rank's block,
its sequence dim never split) and the cached states run per rank
(``_mix_sharded``), the projections as DTensor ops.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.regions import Region
from repro_torch.distributed.sharding import placements_for, shard
from repro_torch.kernels import ops
from repro_torch.kernels.rg_lru import rg_lru_plain

from .common import ParamDef, Tree, activation, dense
from .config import ModelConfig, RunConfig

_C = 8.0  # Griffin's fixed gate sharpness constant


def rglru_defs(cfg: ModelConfig, param_dtype: torch.dtype,
               n_blocks: int = 16) -> Tree:
    d, dr = cfg.d_model, cfg.resolved_d_rnn
    bw = dr // n_blocks
    return {
        "w_x": ParamDef((d, dr), param_dtype, ("embed", "mlp")),
        "w_gate": ParamDef((d, dr), param_dtype, ("embed", "mlp")),
        "w_out": ParamDef((dr, d), param_dtype, ("mlp", "embed")),
        "conv": ParamDef((cfg.conv_width, dr), param_dtype,
                         ("conv", "mlp_act")),
        "conv_b": ParamDef((dr,), param_dtype, ("mlp_act",), init="zeros"),
        # block-diagonal recurrence / input gates; fan-in nb * bw
        "w_a": ParamDef((n_blocks, bw, bw), param_dtype,
                        ("mlp", None, None)),
        "b_a": ParamDef((dr,), param_dtype, ("mlp_act",), init="zeros"),
        "w_i": ParamDef((n_blocks, bw, bw), param_dtype,
                        ("mlp", None, None)),
        "b_i": ParamDef((dr,), param_dtype, ("mlp_act",), init="zeros"),
        # Λ, f32 whatever the param dtype (Griffin appendix init)
        "lam": ParamDef((dr,), torch.float32, ("mlp_act",), init="normal",
                        scale=0.5),
    }


def _blockdiag(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (...,D) @ block-diag(w) with w (nb, bw, bw)."""
    nb, bw, _ = w.shape
    xb = x.reshape(x.shape[:-1] + (nb, bw))
    return torch.einsum("...nb,nbc->...nc", xb, w).reshape(x.shape)


def conv_tail(x: torch.Tensor, w: int) -> torch.Tensor:
    """Last w-1 positions of x (B,S,C), left-padded with zeros if S < w-1
    — the decode-time conv state after a prefill."""
    if w <= 1:
        return x[:, :0]
    s = x.shape[1]
    tail = x[:, -min(s, w - 1):]
    if tail.shape[1] < w - 1:
        tail = F.pad(tail, (0, 0, w - 1 - tail.shape[1], 0))
    return tail


def causal_conv1d(x: torch.Tensor, kernel: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv. x (B,S,C); kernel (W,C); state (B,W-1,C)
    prepends history (decode). Returns x's shape."""
    w = kernel.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], w - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    y = xp[:, 0:s] * kernel[0].to(x.dtype)
    for i in range(1, w):
        y = y + xp[:, i:i + s] * kernel[i].to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


def rglru_scan(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
               lam: torch.Tensor, h0: Optional[torch.Tensor] = None,
               kernel: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU recurrence over (B,S,C) in f32; ``kernel`` runs the scan
    through K10. Returns (h (B,S,C) in x's dtype, h_last (B,C) f32)."""
    xf = x.float()
    log_a = -_C * F.softplus(lam.float())[None, None] * r      # (B,S,C)
    # sqrt(1-a^2) computed stably via expm1: 1-exp(2 log_a)
    b = torch.sqrt(-torch.expm1(2.0 * log_a)) * (i * xf)
    if h0 is not None:
        b = torch.cat([b[:, :1] + torch.exp(log_a[:, :1])
                       * h0.float()[:, None], b[:, 1:]], dim=1)
    h = ops.rg_lru(log_a, b) if kernel else rg_lru_plain(log_a, b)
    return h.to(x.dtype), h[:, -1]


def _rg_mix(p: Dict[str, torch.Tensor], u_raw: torch.Tensor,
            cache: Optional[Dict[str, torch.Tensor]], mode: str,
            kernel: bool, cd: torch.dtype
            ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Conv, gates and the RG-LRU over a block of channels (every op is
    channel-local: the gates' block-diagonal matrices split with them).
    Returns (h (B,S,C), the new cache: ``cache`` updated in place in
    decode, fresh in prefill)."""
    conv_state = cache["conv"] if cache is not None else None
    u = causal_conv1d(u_raw, p["conv"], p["conv_b"], state=conv_state)
    uf = u.float()
    r = torch.sigmoid(_blockdiag(uf, p["w_a"].float()) + p["b_a"].float())
    i = torch.sigmoid(_blockdiag(uf, p["w_i"].float()) + p["b_i"].float())
    if mode == "decode":
        log_a = -_C * F.softplus(p["lam"].float())[None] * r[:, 0]
        a = torch.exp(log_a)
        bsc = torch.sqrt(-torch.expm1(2.0 * log_a))
        h_new = a * cache["h"].float() + bsc * (i[:, 0] * uf[:, 0])
        if p["conv"].shape[0] > 1:
            cache["conv"].copy_(torch.cat(
                [cache["conv"][:, 1:], u_raw.to(cache["conv"].dtype)], dim=1))
        cache["h"].copy_(h_new)
        return h_new[:, None].to(cd), cache
    h0 = cache["h"] if cache is not None else None
    h, h_last = rglru_scan(u, r, i, p["lam"], h0=h0,
                           kernel=kernel and mode == "prefill")
    if mode == "prefill":
        return h, {"conv": conv_tail(u_raw, p["conv"].shape[0]).float(),
                   "h": h_last}
    return h, None


def _mix_sharded(p: Dict[str, torch.Tensor], u_raw: torch.Tensor,
                 cache: Optional[Dict[str, torch.Tensor]], mode: str,
                 kernel: bool, rcfg: RunConfig):
    """``_rg_mix`` per rank on a mesh: each ``model`` rank its block of
    channels (with the gates' diagonal blocks, the conv weight and the
    cached states), each data rank its batch rows; K10 scans each rank's
    block along the whole sequence."""
    from torch.distributed.tensor import Replicate, Shard

    mesh, rules = rcfg.mesh, rcfg.rules
    act = placements_for(("batch", "seq", "mlp_act"), rules, mesh,
                         u_raw.shape)
    blocks = placements_for(("mlp", None, None), rules, mesh,
                            p["w_a"].shape)
    if any(x.is_shard(1) for x in act):
        raise ValueError(
            "rglru on a mesh: the RG-LRU scan runs each rank's channels "
            "along the whole sequence; rules that shard 'seq' are not "
            "supported")
    if any(x.is_shard(2) != y.is_shard(0) for x, y in zip(act, blocks)):
        # channels and gate blocks would split differently: keep them whole
        act = tuple(Replicate() if x.is_shard(2) else x for x in act)

    def chan(dim):          # a channel-indexed leaf, its channels on dim
        return tuple(Shard(dim) if x.is_shard(2) else Replicate()
                     for x in act)

    r = Region.over(mesh, act)
    pl = {k: r.enter(p[k], chan(1) if k == "conv" else chan(0))
          for k in ("conv", "conv_b", "w_a", "b_a", "w_i", "b_i", "lam")}
    loc = None if cache is None else {k: v.to_local()
                                      for k, v in cache.items()}
    hl, nc = _rg_mix(pl, r.enter(u_raw, act), loc, mode, kernel,
                     rcfg.compute_dtype)
    h = r.leave(hl, act)
    if mode != "prefill":
        return h, cache if mode == "decode" else None
    h_pl = tuple(Shard(1) if x.is_shard(2) else x for x in act)
    return h, {"conv": r.leave(nc["conv"], act), "h": r.leave(nc["h"], h_pl)}


def rglru_block_apply(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    cfg: ModelConfig,
    rcfg: RunConfig,
    *,
    mode: str = "train",
    cache: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Griffin recurrent block. x (B,S,D) -> (y (B,S,D), new_cache).

    ``decode`` updates ``cache`` (conv state and h) in place, where the
    reference's engine donates it, and returns it."""
    cd = rcfg.compute_dtype
    mesh, rules = rcfg.mesh, rcfg.rules
    s = x.shape[1]
    if mode == "decode" and (cache is None or s != 1):
        raise ValueError(
            "rglru decode mode needs a cache (from mode='prefill') "
            f"and a single-token input; got cache={cache is not None}, "
            f"seq_len={s}")

    gate = activation("gelu", dense(x, p["w_gate"], None, cd))
    gate = shard(gate, ("batch", "seq", "mlp_act"), rules, mesh)
    u_raw = dense(x, p["w_x"], None, cd)        # pre-conv (cached for decode)
    u_raw = shard(u_raw, ("batch", "seq", "mlp_act"), rules, mesh)
    kernel = rcfg.use_pallas and mode == "prefill"
    if mesh is None:
        h, new_cache = _rg_mix(p, u_raw, cache, mode, kernel, cd)
    else:
        h, new_cache = _mix_sharded(p, u_raw, cache, mode, kernel, rcfg)
    y = dense(gate * h.to(cd), p["w_out"], None, cd)
    return shard(y, ("batch", "res_seq", "embed_act"), rules, mesh), \
        new_cache


def rglru_cache_defs(cfg: ModelConfig, batch: int) -> Tree:
    dr = cfg.resolved_d_rnn
    return {"conv": ParamDef((batch, cfg.conv_width - 1, dr), torch.float32,
                             ("batch", None, "mlp_act"), init="zeros"),
            "h": ParamDef((batch, dr), torch.float32, ("batch", "mlp_act"),
                          init="zeros")}
