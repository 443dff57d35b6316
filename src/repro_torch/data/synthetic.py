"""Deterministic class-conditional synthetic images (numpy, host side).

A copy of ``repro.data.synthetic``'s image generator: the port may not
import the JAX package, and the bytes must match it exactly. The draw order
(labels, then noise; templates from ``default_rng(1234)``) is the contract
that the procedural CIFAR splits derive from.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DatasetSpec:
    name: str
    num_classes: int
    num_images: int
    resolution: int

    @property
    def channels(self):
        return 3


# Paper Table I
DATASETS = {
    "cifar10": DatasetSpec("cifar10", 10, 60_000, 32),
    "cifar100": DatasetSpec("cifar100", 100, 60_000, 32),
    "imagenet100": DatasetSpec("imagenet100", 100, 100_000, 224),
}


def class_conditional_images(spec: DatasetSpec, n: int,
                             rng: np.random.Generator,
                             resolution: int | None = None):
    """Per-class fixed 8x8 template tiled to ``resolution`` plus N(0, 0.7)
    noise. Returns (float32 (n, res, res, 3) images, int32 labels)."""
    res = resolution or spec.resolution
    labels = rng.integers(0, spec.num_classes, (n,))
    trng = np.random.default_rng(1234)
    templates = trng.normal(0, 1, (spec.num_classes, 8, 8, 3)).astype(
        np.float32)
    up = templates[labels]
    reps = res // 8 + 1
    up = np.tile(up, (1, reps, reps, 1))[:, :res, :res]
    noise = rng.normal(0, 0.7, (n, res, res, 3)).astype(np.float32)
    return (up + noise).astype(np.float32), labels.astype(np.int32)
