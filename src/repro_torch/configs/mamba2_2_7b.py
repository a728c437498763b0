"""Mamba2-2.7B  [ssm] — port of ``repro/configs/mamba2_2_7b.py``.

64L d_model=2560 (attention-free) vocab=50280, ssm_state=128, SSD
(state-space duality) with chunk 256, expand 2, head_dim 64 (80 SSM
heads), one group, conv width 4. [arXiv:2405.21060; unverified]

Every layer is a Mamba-2 block (norm → SSD mixer → residual); the stack
loops over the 64 layers as one repeating unit.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    ssm_conv=4,
    ssm_ngroups=1,
    norm="rmsnorm",
)

SMOKE = CONFIG.scaled(
    name="mamba2-smoke",
    n_layers=3, d_model=64, vocab=512, ssm_state=16, ssm_head_dim=16,
    ssm_chunk=16)
