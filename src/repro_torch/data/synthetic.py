"""Spiral classification, the stand-in for the paper's CIFAR experiments.

Port of ``repro/data/synthetic.py::spiral_classification``: k-class
classification of points no linear model separates, lifted to ``dim``
features. The points are drawn with numpy exactly as the reference draws
them, so a seed gives the reference's bits.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device


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
