"""Architecture configurations of the port, one module per architecture
(mirroring ``repro.configs``), and the registry over those ported so far.

    from repro_torch.configs import get_config, get_smoke_config

``get_config``/``get_smoke_config`` return an architecture's ``CONFIG``
(published dims) or ``SMOKE`` (reduced, same family). An architecture of
the reference's registry that the port has not reached raises
``NotImplementedError`` naming it; an unknown name raises ``KeyError``.
"""

from __future__ import annotations

import importlib

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
    "node18_cifar",
)

PORTED = ("recurrentgemma_9b", "mamba2_2_7b", "node18_cifar")


def _norm(name: str) -> str:
    return name.lower().replace("-", "_").replace(".", "_")


def _module(name: str):
    arch = _norm(name)
    if arch not in ARCHS:
        raise KeyError(f"unknown architecture {name!r}; have {ARCHS}")
    if arch not in PORTED:
        raise NotImplementedError(
            f"architecture {arch!r} is not ported yet (ported: {PORTED}; "
            "the dense and MoE families are later slices, ROADMAP queue 1)")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _module(name).SMOKE
