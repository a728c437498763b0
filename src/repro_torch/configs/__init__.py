"""Architecture configurations of the port, one module per architecture
(mirroring ``repro.configs``), and the registry over them.

    from repro_torch.configs import get_config, get_smoke_config, SHAPES

``get_config``/``get_smoke_config`` return an architecture's ``CONFIG``
(published dims) or ``SMOKE`` (reduced, same family); an unknown name
raises ``KeyError``. ``SHAPES`` maps the assignment's input-shape names to
(seq_len, global_batch, kind); ``shape_plan(arch, shape)`` resolves the
skips (``long_500k`` runs on the sub-quadratic archs only).
"""

from __future__ import annotations

import importlib
from typing import Dict, Optional, Tuple

from repro_torch.models.config import ModelConfig

# the reference's registry (repro.configs.ARCHS)
ARCHS = (
    "qwen1_5_32b",
    "qwen2_72b",
    "command_r_plus_104b",
    "command_r_35b",
    "deepseek_moe_16b",
    "qwen3_moe_235b_a22b",
    "llava_next_34b",
    "musicgen_medium",
    "recurrentgemma_9b",
    "mamba2_2_7b",
    # the paper's own model family (NODE-mode image classifier)
    "node18_cifar",
)

PORTED = ARCHS

# assignment shape table: name -> (seq_len, global_batch, step kind)
SHAPES: Dict[str, Tuple[int, int, str]] = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

# archs with sub-quadratic attention that run long_500k
LONG_CONTEXT_ARCHS = ("recurrentgemma_9b", "mamba2_2_7b")


def _norm(name: str) -> str:
    return name.lower().replace("-", "_").replace(".", "_")


def _module(name: str):
    arch = _norm(name)
    if arch not in ARCHS:
        raise KeyError(f"unknown architecture {name!r}; have {ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE


def shape_plan(arch: str, shape: str) -> Optional[Tuple[int, int, str]]:
    """(seq_len, global_batch, kind) or None if the cell is skipped."""
    arch = _norm(arch)
    if shape not in SHAPES:
        raise KeyError(f"unknown shape {shape!r}; have {sorted(SHAPES)}")
    if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return None    # full-attention archs skip 500k
    return SHAPES[shape]
