"""LLaVA-NeXT 34B  [vlm] — port of ``repro/configs/llava_next_34b.py``.

Backbone 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000. The
anyres tiling frontend is a stub: the batch carries precomputed patch and
text embeddings (``embeds``, see ``models/frontends.py``).
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    qkv_bias=False,
    rope_theta=5e6,
    act="silu",
    norm="rmsnorm",
    frontend="vlm",
)

SMOKE = CONFIG.scaled(
    name="llava-next-smoke",
    n_layers=2, d_model=64, n_heads=8, n_kv_heads=2, d_ff=160, vocab=512)
