"""Synthetic CIFAR-like image task (the container is offline).

Deterministic class-conditional generator: each class has a fixed random
low-frequency prototype plus per-example texture noise and random shifts.
Learnable but non-trivial: teacher accuracy saturates well below 100% at the
paper-scale step budgets, so relative comparisons behave like CIFAR's.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ImageTaskConfig:
    n_classes: int = 10
    size: int = 32
    noise: float = 0.6
    shift: int = 4
    seed: int = 0


def _prototypes(cfg: ImageTaskConfig) -> np.ndarray:
    rng = np.random.default_rng(cfg.seed)
    low = rng.normal(size=(cfg.n_classes, 8, 8, 3)).astype(np.float32)
    # upsample 8x8 → size (low-frequency class signal)
    k = cfg.size // 8
    protos = np.repeat(np.repeat(low, k, axis=1), k, axis=2)
    return protos / np.abs(protos).max()


class SyntheticImages:
    def __init__(self, cfg: ImageTaskConfig = ImageTaskConfig()):
        self.cfg = cfg
        self.protos = _prototypes(cfg)

    def batch(self, batch_size: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, seed))
        labels = rng.integers(0, cfg.n_classes, size=batch_size)
        base = self.protos[labels]
        # random shifts
        out = np.empty_like(base)
        for i in range(batch_size):
            dx, dy = rng.integers(-cfg.shift, cfg.shift + 1, 2)
            out[i] = np.roll(base[i], (dx, dy), axis=(0, 1))
        out = out + cfg.noise * rng.normal(size=out.shape).astype(np.float32)
        return out.astype(np.float32), labels.astype(np.int64)

    def epoch(self, batch_size: int, steps: int, seed0: int = 0
              ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for s in range(steps):
            yield self.batch(batch_size, seed0 + s)
