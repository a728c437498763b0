"""RecurrentGemma-9B  [hybrid] — port of ``repro/configs/recurrentgemma_9b.py``.

38L d_model=4096 16H (MQA kv=1, head_dim 256) d_ff=12288 (GeLU, no gate)
vocab=256000; RG-LRU + local attention at 1:2 (pattern rec,rec,attn;
window 2048), d_rnn 4096, conv width 4. [arXiv:2402.19427; unverified]

38 = 12 × (rec, rec, attn) + 2 trailing rec layers: the stack loops over
the 12 repeating groups and applies the tail after them.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    window=2048,
    pattern=("rec", "rec", "attn"),
    d_rnn=4096,
    conv_width=4,
    rope_theta=1e4,
    act="gelu",
    norm="rmsnorm",
)

SMOKE = CONFIG.scaled(
    name="recurrentgemma-smoke",
    n_layers=8, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=160, vocab=512, window=16, d_rnn=64)
