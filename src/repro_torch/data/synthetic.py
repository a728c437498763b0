"""Synthetic token and classification pipelines (offline substitutes).

Port of ``repro/data/synthetic.py``. ``TokenPipeline`` generates LM
batches with Zipfian token statistics and a deterministic (seed, step) ->
batch map, each row seeded on its own so a host materializes only its
slice of the global batch. ``spiral_classification`` is the stand-in for
the paper's CIFAR experiments: k-class classification of points no
linear model separates, lifted to ``dim`` features. Both draw with numpy
exactly as the reference draws, so a seed gives the reference's bits.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    """LM batches on ``device`` (the card unless the caller asks for the
    CPU): ``tokens`` and ``labels`` (B, seq_len) int32, the labels the
    tokens shifted by one, and a ``mask`` of ones."""
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    device: str = "cuda"

    def batch(self, step: int,
              host_slice: Optional[Tuple[int, int]] = None
              ) -> Dict[str, torch.Tensor]:
        """Batch for ``step``; host_slice=(host_idx, n_hosts) selects the
        host-local rows of the global batch."""
        b = self.global_batch
        lo, hi = 0, b
        if host_slice is not None:
            idx, n = host_slice
            per = b // n
            lo, hi = idx * per, (idx + 1) * per
        # per-row seeding: a host draws only its rows, yet gets exactly the
        # global batch's rows lo..hi
        rows = []
        for r in range(lo, hi):
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, r]))
            rows.append(rng.zipf(self.zipf_a, size=self.seq_len + 1))
        z = np.stack(rows)
        toks = torch.from_numpy(
            np.minimum(z - 1, self.vocab - 1).astype(np.int32))
        dev = resolve_device(self.device)
        return {
            "tokens": toks[:, :-1].contiguous().to(dev),
            "labels": toks[:, 1:].contiguous().to(dev),
            "mask": torch.ones((hi - lo, self.seq_len), dtype=torch.float32,
                               device=dev),
        }


def spiral_classification(n: int, n_classes: int = 3, noise: float = 0.15,
                          dim: int = 16, seed: int = 0, lift_seed: int = 0,
                          device="cuda"
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k-arm spiral classification, lifted to ``dim`` features.

    ``seed`` draws the points; ``lift_seed`` draws the (fixed) feature
    lift — train/test splits must share it. Returns (x (n', dim) f32,
    y (n',) int64) on ``device``, n' = (n // n_classes) * n_classes."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    per = n // n_classes
    xs, ys = [], []
    for c in range(n_classes):
        t = np.linspace(0.3, 2.5 * np.pi, per)
        r = t / (2.5 * np.pi)
        ang = t + 2 * np.pi * c / n_classes
        pts = np.stack([r * np.cos(ang), r * np.sin(ang)], 1)
        pts += rng.normal(scale=noise * r[:, None], size=pts.shape)
        xs.append(pts)
        ys.append(np.full(per, c))
    x2 = np.concatenate(xs).astype(np.float32)
    y = np.concatenate(ys)
    # random fixed lift to `dim` features (keeps the task, adds width)
    lift_rng = np.random.default_rng(lift_seed)
    lift = lift_rng.normal(size=(2, dim)).astype(np.float32) / np.sqrt(2)
    x = (x2 @ lift).astype(np.float32)   # the lift is f64: / np.sqrt(2)
    perm = rng.permutation(len(y))
    return (torch.from_numpy(np.ascontiguousarray(x[perm])).to(dev),
            torch.from_numpy(y[perm].astype(np.int64)).to(dev))
