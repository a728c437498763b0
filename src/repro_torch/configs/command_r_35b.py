"""Command R 35B  [dense] — port of ``repro/configs/command_r_35b.py``.

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000, no bias,
parallel block, tied embeddings, LayerNorm.
[hf:CohereForAI/c4ai-command-r-v01; unverified]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab=256000,
    qkv_bias=False,
    rope_theta=8e6,
    act="silu",
    norm="layernorm",
    norm_eps=1e-5,
    parallel_block=True,
    tie_embeddings=True,
)

SMOKE = CONFIG.scaled(
    name="command-r-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=160, vocab=512)
