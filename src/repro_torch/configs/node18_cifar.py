"""NODE18 — the paper's own model family (Sec. 4.2), port of
``repro/configs/node18_cifar.py``.

The paper turns ResNet18's residual blocks into ODE blocks with the same
parameters and trains with HeunEuler at rtol=atol=1e-2 (Appendix D). The
repository keeps a transformer-backbone counterpart: ``CONFIG`` is the
full-width model (d_model 768, 12 heads, d_ff 3072), ``SMOKE`` the
reduced one, ``NODE_TRAIN`` the paper-matching NODE solver settings
with the fused kernel path on, and ``NODE_TRAIN_MALI`` its reversible
variant (the ALF pair stepper, MALI gradients, no state stored per step).
"""

from repro_torch.core.node_block import NodeConfig
from repro_torch.models.config import ModelConfig

NODE_TRAIN = NodeConfig(
    enabled=True,
    solver="heun_euler",
    grad_method="aca",
    rtol=1e-2,
    atol=1e-2,
    use_pallas=True,
    # O(sqrt(max_steps))-state segmented ACA, as in the reference: at
    # max_steps 32, K = 6 snapshots of seg_len 6; the gradients are the
    # full buffer's bit for bit
    checkpoint_segments="auto",
)

# the reversible variant, as the reference publishes it: ALF is second
# order like HeunEuler's advancing method, at the paper's tolerance; the
# backward inverts the accepted steps (K1 for the half-drifts), so the
# block's state memory does not grow with the step count
NODE_TRAIN_MALI = NodeConfig(
    enabled=True,
    solver="alf",
    grad_method="mali",
    rtol=1e-2,
    atol=1e-2,
    use_pallas=True,
)

CONFIG = ModelConfig(
    name="node18-cifar",
    family="dense",
    n_layers=18,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=32768,
    rope_theta=1e4,
    act="silu",
    norm="rmsnorm",
)

SMOKE = CONFIG.scaled(
    name="node18-smoke",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160, vocab=512)
