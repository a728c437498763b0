"""Three-term roofline of one rank on an NVIDIA H100.

The counterpart of ``repro/launch/roofline.py``::

    compute    = sum over dtypes of FLOPs_per_rank[dtype] / peak[dtype]
    memory     = bytes_per_rank                          / HBM rate
    collective = collective_bytes_per_rank               / link rate

The FLOPs, bytes and collective records come from ``launch/op_cost.py``'s
counter over one rank's work (the reference reads them off XLA's
per-device HLO). Collective bytes keep the reference's ring factors:
all-reduce moves about twice its payload a rank, all-gather,
reduce-scatter, all-to-all and permute about once, each of the larger of
result and operand.

Compute time is summed per dtype: an f32 NODE cell runs outside the
tensor cores, 15x below the bf16 peak, and one bf16 constant would
understate its time that much. ``roofline_fraction`` keeps the
reference's meaning: the useful FLOPs (``model_flops``) at the bf16 peak
over the bound time.

Hardware constants (NVIDIA H100 SXM5 data sheet, dense, no sparsity):
bf16 tensor cores 989 TFLOP/s, f32 outside the tensor cores 67 TFLOP/s,
HBM3 3.35 TB/s, NVLink 4 at 450 GB/s per direction per GPU. NVLink joins
the 8 GPUs of one node; a 16 x 16 mesh (256 ranks, 32 nodes) spans nodes,
where a rank's link is the node's network (400 Gb/s InfiniBand a GPU,
about 50 GB/s), so ``t_collective`` at the NVLink rate is a lower bound
there.

``model_flops`` cross-checks the counted compute against the 6·N·D
(train) / 2·N·D (inference) convention with N the active parameters; the
ratio exposes recompute and padding (e.g. MoE capacity slots).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

from repro_torch.models.config import ModelConfig

# NVIDIA H100 SXM5 data sheet
PEAK_FLOPS = 989e12          # bf16 dense tensor cores, FLOP/s
F32_FLOPS = 67e12            # f32 outside the tensor cores, FLOP/s
HBM_BW = 3.35e12             # HBM3, bytes/s
LINK_BW = 450e9              # NVLink 4, bytes/s per direction per GPU

PEAK_BY_DTYPE = {"bf16": PEAK_FLOPS, "f16": PEAK_FLOPS, "f32": F32_FLOPS,
                 "f64": 34e12}   # f64 outside the tensor cores

_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
           "all-to-all": 1.0, "collective-permute": 1.0}


def peak_flops(dtype: str) -> float:
    """The card's peak FLOP/s for operands of ``dtype`` ("bf16", "f32",
    ...); an integer or unknown dtype runs at the f32 rate."""
    return PEAK_BY_DTYPE.get(dtype, F32_FLOPS)


def kernel_bound(work: Tuple[Dict[str, float], float]) -> Tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card takes for a
    kernel's ``work`` = (FLOPs by dtype, bytes), each input read and each
    output written once at the HBM rate, or the FLOPs at their dtypes'
    peaks, whichever is longer."""
    flops, nbytes = work
    by_bytes = nbytes / HBM_BW
    by_ops = sum(f / peak_flops(k) for k, f in flops.items())
    return 1e3 * max(by_bytes, by_ops), \
        "bytes" if by_bytes >= by_ops else "operations"


def collective_bytes(records: Iterable[Tuple[str, float, float]]
                     ) -> Tuple[float, Dict[str, float]]:
    """Per-rank collective bytes (ring-factor scaled) by kind, from the
    counter's records ``(kind, result_bytes, operand_bytes)``."""
    per_kind: Dict[str, float] = {}
    for kind, res, opnd in records:
        per_kind[kind] = per_kind.get(kind, 0.0) + _FACTOR[kind] * max(
            res, opnd)
    return sum(per_kind.values()), per_kind


def active_params(cfg: ModelConfig) -> int:
    """Parameters touched per token (dense: all; MoE: shared + top-k)."""
    d = cfg.d_model
    dh = cfg.resolved_head_dim
    per_layer_attn = d * (cfg.n_heads + 2 * cfg.n_kv_heads) * dh \
        + cfg.n_heads * dh * d
    emb = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    if cfg.frontend != "none":
        emb = cfg.vocab * d           # lm head only
    if cfg.family == "moe":
        f = cfg.d_expert
        per_layer_ffn = (cfg.top_k + cfg.n_shared_experts) * 3 * d * f \
            + d * cfg.n_experts       # router
    elif cfg.family == "ssm":
        di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
        per_layer_attn = 0
        per_layer_ffn = 2 * d * di + 2 * d * cfg.ssm_ngroups * n \
            + d * h + di * d
    elif cfg.family == "hybrid":
        from repro_torch.models.transformer import layer_kinds

        dr = cfg.resolved_d_rnn
        n_attn = sum(1 for k in layer_kinds(cfg) if k == "attn")
        n_rec = cfg.n_layers - n_attn
        gated = 3 if cfg.act == "silu" else 2
        per_layer = (n_attn * (per_layer_attn + gated * d * cfg.d_ff)
                     + n_rec * (3 * d * dr + 2 * dr * dr // 16
                                + gated * d * cfg.d_ff)) // cfg.n_layers
        return emb + per_layer * cfg.n_layers
    else:
        gated = 3 if cfg.act == "silu" else 2
        per_layer_ffn = gated * d * cfg.d_ff
    return emb + cfg.n_layers * (per_layer_attn + per_layer_ffn)


def model_flops(cfg: ModelConfig, kind: str, seq: int, batch: int) -> float:
    """Reference FLOPs (global): 6·N·tokens train, 2·N·tokens inference.

    decode processes 1 token per sequence (batch tokens total)."""
    n = active_params(cfg)
    if kind == "train":
        return 6.0 * n * seq * batch
    if kind == "prefill":
        return 2.0 * n * seq * batch
    return 2.0 * n * batch        # decode: one token per sequence


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_by_kind: Dict[str, float]
    n_devices: int
    model_flops_global: float
    # extras filled by analyze()
    bytes_all_per_device: float = 0.0   # every op's operands and results
    # XLA's own aggregate in the reference; the port has no compiler
    # aggregate, so these stay 0
    xla_cost_flops: float = 0.0
    xla_cost_bytes: float = 0.0
    dynamic_whiles: int = 0
    breakdown: Optional[list] = None
    # FLOPs by operand dtype; None: all at the bf16 peak
    flops_by_dtype: Optional[Dict[str, float]] = None

    @property
    def t_compute(self) -> float:
        if not self.flops_by_dtype:
            return self.flops_per_device / PEAK_FLOPS
        return sum(f / peak_flops(k) for k, f in self.flops_by_dtype.items())

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_device / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flop_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs (global) — recompute/padding gauge."""
        counted = self.flops_per_device * self.n_devices
        return self.model_flops_global / max(counted, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """useful-FLOPs time at the bf16 peak / bound time."""
        t_useful = (self.model_flops_global / self.n_devices) / PEAK_FLOPS
        return t_useful / max(self.bound_time, 1e-30)

    def to_dict(self) -> Dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "coll_bytes_per_device": self.coll_bytes_per_device,
            "coll_by_kind": self.coll_by_kind,
            "n_devices": self.n_devices,
            "model_flops_global": self.model_flops_global,
            "t_compute": self.t_compute,
            "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "dominant": self.dominant,
            "useful_flop_ratio": self.useful_flop_ratio,
            "roofline_fraction": self.roofline_fraction,
            "bytes_all_per_device": self.bytes_all_per_device,
            "xla_cost_flops": self.xla_cost_flops,
            "xla_cost_bytes": self.xla_cost_bytes,
            "dynamic_whiles": self.dynamic_whiles,
            "breakdown_top10": (self.breakdown or [])[:10],
        }


def from_cost(cost, n_devices: int, model_flops_global: float) -> Roofline:
    """The roofline of one rank's ``op_cost.OpCost`` counts."""
    total, by_kind = collective_bytes(cost.collectives())
    r = Roofline(flops_per_device=cost.flops,
                 bytes_per_device=cost.bytes_min,
                 coll_bytes_per_device=total, coll_by_kind=by_kind,
                 n_devices=n_devices,
                 model_flops_global=model_flops_global)
    r.bytes_all_per_device = cost.bytes
    r.dynamic_whiles = cost.dynamic_whiles
    r.breakdown = [list(row) for row in cost.breakdown]
    r.flops_by_dtype = dict(cost.flops_by_dtype)
    return r


def analyze(cost, cfg: ModelConfig, kind: str, seq: int, batch: int,
            n_devices: int) -> Roofline:
    """The roofline of an LM cell from one rank's counts."""
    return from_cost(cost, n_devices, model_flops(cfg, kind, seq, batch))
