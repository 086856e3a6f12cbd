"""Shuffled fixed-shape batches with a validity mask.

A copy of `EpochBatcher` (`vit3d_ensemble_tpu/data/pipeline.py:120-166`).
It draws from the same `np.random.default_rng(seed)` stream, so its batches
are element-equal to the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass
class EpochBatcher:
    """Shuffled fixed-shape batches with a validity mask.

    The reference's RandomSampler DataLoader yields a ragged final batch
    (`utils/data_utils_cv.py:49-51`); the final batch is padded instead and
    its padded rows are masked out of the loss and the pos_weight.
    """

    n: int
    batch_size: int
    seed: int = 42
    shuffle: bool = True

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    @property
    def steps_per_epoch(self) -> int:
        return -(-self.n // self.batch_size)

    def epoch(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Yields (indices (B,), mask (B,)) per step."""
        order = (self._rng.permutation(self.n) if self.shuffle
                 else np.arange(self.n))
        B = self.batch_size
        for s in range(self.steps_per_epoch):
            chunk = order[s * B:(s + 1) * B]
            mask = np.ones(B, dtype=np.float32)
            if len(chunk) < B:
                mask[len(chunk):] = 0.0
                chunk = np.concatenate(
                    [chunk, np.zeros(B - len(chunk), dtype=chunk.dtype)])
            yield chunk, mask

    def batches(self, num_steps: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Infinite epoch stream truncated at num_steps (the reference's
        `while True` epoch loop + global_step cap, `train_baseline_cv.py:154`).
        """
        done = 0
        while done < num_steps:
            for idx, mask in self.epoch():
                yield idx, mask
                done += 1
                if done >= num_steps:
                    return
