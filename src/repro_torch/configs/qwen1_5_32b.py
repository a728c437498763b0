"""Qwen1.5-32B  [dense] — port of ``repro/configs/qwen1_5_32b.py``.

64L d_model=5120 40H (GQA kv=40, i.e. MHA) d_ff=27392 vocab=152064, QKV
bias, RoPE theta 1e6. [hf:Qwen/Qwen1.5-0.5B; hf]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1e6,
    act="silu",
    norm="rmsnorm",
)

SMOKE = CONFIG.scaled(
    name="qwen1.5-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160, vocab=512)
