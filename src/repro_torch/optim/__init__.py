"""repro_torch.optim — AdamW and the learning-rate schedules of the port.

Port of ``repro.optim``'s ``adamw`` and ``schedule``, functional over
pytrees (dicts, tuples, lists) of tensors. ``sgd`` and the gradient
utilities come with slice G4 (LM training).
"""

from .adamw import AdamWState, Optimizer, adamw, apply_updates
from .schedule import constant, cosine_warmup, exponential_decay, step_decay

__all__ = [
    "AdamWState", "Optimizer", "adamw", "apply_updates",
    "constant", "cosine_warmup", "exponential_decay", "step_decay",
]
