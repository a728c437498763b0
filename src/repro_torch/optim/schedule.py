"""Learning-rate schedules: functions of an integer step tensor.

Port of ``repro/optim/schedule.py``. Each returns a 0-d f32 tensor on the
step's device, computed in f32 as the reference computes it.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def _f32(x, step: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=step.device)


def constant(lr: float):
    return lambda step: _f32(lr, step)


def step_decay(lr: float, boundaries: Sequence[int], factor: float = 0.1):
    """The paper's schedule: decay by ``factor`` at each boundary epoch."""
    def f(step):
        bs = torch.tensor(list(boundaries), dtype=torch.int32,
                          device=step.device)
        n = (step >= bs).sum()
        return _f32(lr, step) * _f32(factor, step) ** n.float()

    return f


def exponential_decay(lr: float, decay: float):
    """lr · decay^step (the paper's three-body experiments, Eq. 83)."""
    def f(step):
        return _f32(lr, step) * _f32(decay, step) ** step.float()

    return f


def cosine_warmup(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warmup then cosine decay to final_frac·peak (LM training)."""
    def f(step):
        s = step.float()
        warm = peak_lr * s / max(warmup_steps, 1)
        t = torch.clamp((s - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * t))
        return torch.where(s < warmup_steps, warm, peak_lr * cos)

    return f
