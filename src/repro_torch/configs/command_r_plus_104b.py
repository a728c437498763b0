"""Command R+ 104B  [dense] — port of
``repro/configs/command_r_plus_104b.py``.

64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000, no bias,
parallel attention + FFN block (one LayerNorm feeds both), tied
embeddings. [hf:CohereForAI/c4ai-command-r-v01; unverified]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab=256000,
    qkv_bias=False,
    rope_theta=75e6,
    act="silu",
    norm="layernorm",
    norm_eps=1e-5,
    parallel_block=True,
    tie_embeddings=True,
)

SMOKE = CONFIG.scaled(
    name="command-r-plus-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=160, vocab=512)
