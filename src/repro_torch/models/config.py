"""Model / run configuration dataclasses of the port.

``ModelConfig`` is a copy of ``repro/models/config.py``'s (one per
architecture in ``repro_torch.configs``). ``RunConfig`` keeps what the
ported paths read, the reference's sharding knobs included: ``mesh`` (a
torch ``DeviceMesh``), ``rules`` (its logical-axis rules),
``decode_seq_shard`` and ``zero1``, and the activation policy ``remat``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch

from repro_torch.core.node_block import NodeConfig
from repro_torch.distributed.sharding import DEFAULT_TRAIN_RULES, AxisRules


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm
    n_layers: int
    d_model: int
    vocab: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0           # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    window: int = 0             # sliding-window size (0 = full attention)
    # ffn
    d_ff: int = 0
    act: str = "silu"
    mlp_bias: bool = False
    norm: str = "rmsnorm"
    norm_eps: float = 1e-6
    parallel_block: bool = False  # command-r style: attn+ffn from same norm
    tie_embeddings: bool = False
    # moe
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_expert: int = 0           # per-expert FFN width
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    # hybrid (recurrentgemma): repeating block pattern
    pattern: Tuple[str, ...] = ()      # e.g. ("rec", "rec", "attn")
    d_rnn: int = 0              # RG-LRU width (0 -> d_model)
    conv_width: int = 4
    # ssm (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv: int = 4
    ssm_ngroups: int = 1
    # frontend stub
    frontend: str = "none"      # none | vlm | audio

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def d_inner(self) -> int:  # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def resolved_d_rnn(self) -> int:
        return self.d_rnn or self.d_model

    def scaled(self, **overrides) -> "ModelConfig":
        """Reduced config of the same family (smoke tests)."""
        return dataclasses.replace(self, **overrides)


REMAT_POLICIES = ("none", "block")


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """How a model runs.

    ``compute_dtype`` is what ``dense`` casts its operands to (bf16 by
    default, as in the reference) and ``param_dtype`` what ``init`` stores
    (RG-LRU's ``lam`` and Mamba-2's ``dt_bias``, ``a_log``, ``d_skip`` stay
    f32 whatever it is). ``node`` turns the residual
    blocks into ODE blocks. ``use_pallas`` — the reference's switch for its
    TPU kernels — sends the serving modes (``prefill``, ``decode``) through
    the card kernels K7 (every RMSNorm), K8 (prefill attention), K9 (prefill
    SSD scan) and K10 (prefill RG-LRU scan); on CPU tensors those wrappers run their plain
    versions. In train mode with ``node.enabled`` it also turns on the
    NODE blocks' fused solver path (K1/K2, or K3/K4 under
    ``batch_axis=0``), as in the reference. ``max_seq`` is the KV-cache
    capacity of serving and ``label_smoothing`` the loss's.

    ``mesh`` is a torch ``DeviceMesh`` with named dims (``data``,
    ``model``, optionally ``pod``; ``repro_torch.launch.mesh``): with
    one, parameters, activations, caches and optimizer moments are
    DTensors placed by ``rules``, the MoE block runs its expert-parallel
    dispatch over ``model``, and decode shards the KV cache's sequence dim
    over ``model`` (flash-decode) when ``decode_seq_shard``. The optimizer
    moments always carry their parameters' placements (ZeRO); ``zero1`` is
    kept as the reference declares it, and, as there, nothing reads it.
    A NODE stack (``node.enabled``) on a mesh solves each block per rank
    on its batch block (``models/transformer.py``).

    ``remat`` is the reference's activation policy: ``"none"``, or
    ``"block"``, under which a train step recomputes each layer group's
    activations in the backward (``torch.utils.checkpoint`` around the
    group's body, NODE blocks included), where the reference's default
    ``scan_layers=True`` checkpoints its scan body; with one group, and
    for the tail, nothing is recomputed, as there. ``scan_layers`` is left
    out: an eager stack loops over the groups in Python and has nothing to
    scan.
    """
    compute_dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    node: NodeConfig = NodeConfig()       # continuous-depth (the paper)
    use_pallas: bool = False
    max_seq: int = 0                      # KV-cache capacity (serving)
    label_smoothing: float = 0.0
    mesh: Any = None
    rules: AxisRules = DEFAULT_TRAIN_RULES
    decode_seq_shard: bool = True         # flash-decode over the mesh
    zero1: bool = True                    # read nowhere, as in the reference
    remat: str = "none"                   # none | block (activation ckpt)

    def __post_init__(self):
        if self.remat not in REMAT_POLICIES:
            raise ValueError(
                f"RunConfig.remat must be one of {REMAT_POLICIES}; got "
                f"{self.remat!r}")

    def with_(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)
