"""Qwen3-MoE 235B-A22B  [moe] — port of
``repro/configs/qwen3_moe_235b_a22b.py``.

94L d_model=4096 64H (GQA kv=4, head_dim=128) expert d_ff=1536
vocab=151936; 128 experts top-8, no shared experts.
[hf:Qwen/Qwen3-30B-A3B; hf]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab=151936,
    n_experts=128,
    n_shared_experts=0,
    top_k=8,
    d_expert=1536,
    capacity_factor=1.25,
    rope_theta=1e6,
    act="silu",
    norm="rmsnorm",
)

SMOKE = CONFIG.scaled(
    name="qwen3-moe-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=96, vocab=512, n_experts=8, top_k=2, d_expert=96)
