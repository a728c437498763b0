"""Batched LM serving engine: prefill once, decode step by step.

Port of ``repro/serve/engine.py``'s static-batch engine:

* ``prefill``  — one forward over the (B, S_prompt) batch that writes the
  fixed-capacity per-layer caches (ring buffers for windowed attention,
  conv and h states for RG-LRU);
* ``generate`` — ``decode_step`` applied autoregressively with greedy
  (``argmax``) or temperature sampling. Where the reference's jitted
  decode donates the caches, the port updates them in place.

The KV-cache capacity is ``model.rcfg.max_seq``. Sampling draws from a
``torch.Generator`` on the logits' device; the numbers differ from
``jax.random``'s, greedy decoding uses none.

On a mesh (``model.rcfg.mesh``, DTensor parameters) the engine is the
same: the prefill returns caches placed by ``Model.cache_specs`` (the KV
cache's sequence dim over ``model``), each decode step writes a new key
on the rank whose block holds its slot, and the logits come back whole
on every rank, so every rank samples the same tokens.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.common import Tree
from repro_torch.models.lm import Model

# generate() with temperature sampling and no explicit generator falls
# back to a fixed seed; warn once per process so the silent determinism is
# at least visible (tests set this back to False to re-trigger).
_warned_default_generator = False


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0      # 0 => greedy
    eos_id: int = -1              # -1 => never stop early


class ServeEngine:
    def __init__(self, model: Model, params: Tree,
                 cfg: Optional[ServeConfig] = None):
        self.model = model
        self.params = params
        self.cfg = cfg or ServeConfig()
        # decode iterations run by the last generate() call — observability
        # for the eos early-break (and its tests)
        self.last_decode_steps = 0

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, Tree]:
        return self.model.prefill(self.params, {"tokens": tokens})

    def _sample(self, logits: torch.Tensor,
                gen: torch.Generator) -> torch.Tensor:
        if self.cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.float() / self.cfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(
            torch.int32)

    @torch.no_grad()
    def generate(self, tokens: torch.Tensor,
                 generator: Optional[torch.Generator] = None
                 ) -> Dict[str, torch.Tensor]:
        """tokens (B, S_prompt) -> {"tokens": (B, S_prompt + new)}.

        ``generator=None`` uses a *fixed* generator seeded 0 on the tokens'
        device: with ``temperature > 0`` every such call samples the same
        sequence. Pass your own generator for varied samples; the fallback
        warns once per process when temperature sampling is active (greedy
        decoding draws nothing).
        """
        if generator is None:
            if self.cfg.temperature > 0.0:
                global _warned_default_generator
                if not _warned_default_generator:
                    _warned_default_generator = True
                    warnings.warn(
                        "ServeEngine.generate(generator=None) with "
                        "temperature > 0 uses a fixed generator seeded 0: "
                        "every such call samples identical tokens. Pass an "
                        "explicit torch.Generator for fresh randomness.",
                        UserWarning, stacklevel=2)
            generator = torch.Generator(device=tokens.device).manual_seed(0)
        b, s = tokens.shape
        logits, caches = self.prefill(tokens)
        outs = [tokens.to(torch.int32)]
        nxt = self._sample(logits, generator)
        outs.append(nxt[:, None])
        eos = self.cfg.eos_id
        # the first sampled token can already be eos: seed `done` from it
        # so the row stops and an all-finished batch skips the decode loop
        done = nxt == eos if eos >= 0 else None
        self.last_decode_steps = 0
        for i in range(self.cfg.max_new_tokens - 1):
            if done is not None and bool(done.all()):
                break
            logits, caches = self.model.decode_step(
                self.params, {"tokens": nxt[:, None]}, caches, s + i)
            self.last_decode_steps += 1
            nxt = self._sample(logits, generator)
            if done is not None:
                done = done | (nxt == eos)
                nxt = torch.where(done, torch.full_like(nxt, eos), nxt)
            outs.append(nxt[:, None])
        return {"tokens": torch.cat(outs, dim=1)}
