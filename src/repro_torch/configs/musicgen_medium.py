"""MusicGen-medium  [audio] — port of ``repro/configs/musicgen_medium.py``.

Decoder-only over EnCodec tokens: 48L d_model=1536 24H (kv=24, MHA, head
dim 64) d_ff=6144 vocab=2048 (the codebook size), LayerNorm and a plain
(non-gated) GeLU FFN. The EnCodec frontend is a stub: the batch carries
precomputed frame embeddings (``embeds``). [arXiv:2306.05284; hf]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="dense",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab=2048,
    qkv_bias=False,
    rope_theta=1e4,
    act="gelu",
    norm="layernorm",
    norm_eps=1e-5,
    frontend="audio",
)

SMOKE = CONFIG.scaled(
    name="musicgen-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160, vocab=256)
