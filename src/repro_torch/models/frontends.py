"""Modality frontend stubs: the ``vlm`` and ``audio`` archs run their
transformer backbone on precomputed embeddings.

Port of ``repro/models/frontends.py``:

  * llava-next — "anyres" tiling gives N patch embeddings an image; the
    stub supplies ``embeds`` = concat(patch_embeds, text_embeds), already
    projected to d_model;
  * musicgen — EnCodec gives 4-codebook frames; the stub supplies each
    frame's summed codebook embeddings at d_model.

``frontend_batch_abstract`` gives the batch's ``{name: (shape, dtype)}``
(the port has no ShapeDtypeStruct); ``frontend_batch_synthetic`` draws one
from a ``torch.Generator`` (N(0, 0.02²) embeds, uniform labels, a mask of
ones). Its numbers differ from ``jax.random``'s; tests carry the
reference's batch over.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.device import resolve_device

from .config import ModelConfig


def frontend_batch_abstract(cfg: ModelConfig, batch: int, seq: int,
                            compute_dtype: torch.dtype = torch.bfloat16
                            ) -> Dict[str, Tuple[Tuple[int, ...],
                                                 torch.dtype]]:
    """Shapes and dtypes of a frontend-stub arch's train batch."""
    return {
        "embeds": ((batch, seq, cfg.d_model), compute_dtype),
        "labels": ((batch, seq), torch.int32),
        "mask": ((batch, seq), torch.float32),
    }


def frontend_batch_synthetic(cfg: ModelConfig, batch: int, seq: int,
                             seed: int = 0,
                             compute_dtype: torch.dtype = torch.bfloat16,
                             device="cuda") -> Dict[str, torch.Tensor]:
    """A random train batch for a frontend-stub arch on ``device``, drawn
    from a generator on that device seeded with ``seed``."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    embeds = torch.randn((batch, seq, cfg.d_model), generator=gen,
                         device=dev)
    return {
        "embeds": (embeds * 0.02).to(compute_dtype),
        "labels": torch.randint(0, cfg.vocab, (batch, seq), generator=gen,
                                device=dev, dtype=torch.int32),
        "mask": torch.ones((batch, seq), dtype=torch.float32, device=dev),
    }
