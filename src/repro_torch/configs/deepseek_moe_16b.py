"""DeepSeek-MoE 16B  [moe] — port of ``repro/configs/deepseek_moe_16b.py``.

28L d_model=2048 16H (kv=16, head dim 128) expert d_ff=1408 vocab=102400;
2 shared + 64 routed experts, top-6 (fine-grained expert segmentation).
[arXiv:2401.06066; hf]

As in the reference, all 28 layers are MoE blocks (the published model
keeps layer 0 dense); the stack loops over one repeating unit.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab=102400,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    d_expert=1408,
    capacity_factor=1.25,
    rope_theta=1e4,
    act="silu",
    norm="rmsnorm",
)

SMOKE = CONFIG.scaled(
    name="deepseek-moe-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96, vocab=512,
    n_experts=8, n_shared_experts=1, top_k=2, d_expert=96)
