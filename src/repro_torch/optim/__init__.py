"""repro_torch.optim — optimizers, schedules and gradient utilities of
the port.

Port of ``repro.optim``: ``adamw``, ``sgd``, the schedules and
``grad_utils`` (clipping, int8 and top-k compression with error
feedback), functional over pytrees (dicts, tuples, lists) of tensors.
"""

from .adamw import AdamWState, Optimizer, adamw, apply_updates
from .grad_utils import (CompressionState, clip_by_global_norm, global_norm,
                         init_compression_state, int8_compress_decompress,
                         topk_sparsify)
from .schedule import constant, cosine_warmup, exponential_decay, step_decay
from .sgd import SGDState, sgd

__all__ = [
    "AdamWState", "Optimizer", "adamw", "apply_updates", "SGDState", "sgd",
    "constant", "cosine_warmup", "exponential_decay", "step_decay",
    "clip_by_global_norm", "global_norm", "init_compression_state",
    "int8_compress_decompress", "topk_sparsify", "CompressionState",
]
