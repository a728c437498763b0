"""Device resolution shared by the port's model constructors and entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, refusing a CUDA device when there is no
    card (no silent fall-back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"asked for device {device!r} but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev
