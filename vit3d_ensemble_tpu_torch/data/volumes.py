"""A whole split as dense arrays, the unit the trainers consume.

A copy of `SplitArrays` (`vit3d_ensemble_tpu/data/volumes.py:119-147`),
kept in the port so that it imports nothing of the JAX package and no
pandas.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass
class SplitArrays:
    """A whole split as dense arrays — the unit the training stack consumes."""

    volumes: np.ndarray          # (N, H, W, Z, 1) float32, channels-last
    labels: np.ndarray           # (N,) int32 — LG=0, HG=1
    patients: List[str]
    zones: List[str]

    def __len__(self) -> int:
        return len(self.labels)

    def subset(self, idx: Sequence[int]) -> "SplitArrays":
        idx = np.asarray(idx)
        return SplitArrays(
            volumes=self.volumes[idx],
            labels=self.labels[idx],
            patients=[self.patients[i] for i in idx],
            zones=[self.zones[i] for i in idx],
        )

    @staticmethod
    def concat(parts: Sequence["SplitArrays"]) -> "SplitArrays":
        return SplitArrays(
            volumes=np.concatenate([p.volumes for p in parts]),
            labels=np.concatenate([p.labels for p in parts]),
            patients=sum((p.patients for p in parts), []),
            zones=sum((p.zones for p in parts), []),
        )
