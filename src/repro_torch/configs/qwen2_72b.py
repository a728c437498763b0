"""Qwen2-72B  [dense] — port of ``repro/configs/qwen2_72b.py``.

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064, GQA + QKV bias,
RoPE theta 1e6. [arXiv:2407.10671; hf]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    qkv_bias=True,
    rope_theta=1e6,
    act="silu",
    norm="rmsnorm",
)

SMOKE = CONFIG.scaled(
    name="qwen2-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=160, vocab=512)
