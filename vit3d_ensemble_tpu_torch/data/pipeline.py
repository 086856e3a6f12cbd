"""Split assembly: normalization, augmentation policy, bootstrap, batching.

The counterpart of `vit3d_ensemble_tpu/data/pipeline.py` (the reference's
loaders: fixed split `utils/data_utils.py:18-58`, 5-fold CV
`utils/data_utils_cv.py:18-54`, bootstrap `utils/data_utils_bootstrap.py:
22-61` + `tools.py:137-147`), without pandas:

  * scalar mean-centring, the mean taken in float64 over the
    PRE-augmentation trainset on the host and applied to train and
    validation (`utils/data_utils_cv.py:26-27,43-44`; std divisor 1);
  * class-imbalance augmentation: the 3 augmented variants of every 3rd
    high-grade training item (hg_positions[::3]) are APPENDED, grouped by
    variant (`utils/data_utils_cv.py:29-40`), read from the precomputed
    folders ('disk') or computed on the device ('device');
  * bootstrap resampling picks the rows that pandas'
    `df.sample(n=len, replace=True, random_state=seed)` picks
    (`tools.py:137-147`).

`EpochBatcher` draws from the same `np.random.default_rng(seed)` stream as
the JAX package's, so its batches are element-equal.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple, Union

import numpy as np
import torch

from vit3d_ensemble_tpu_torch.data.augment import augment_batch
from vit3d_ensemble_tpu_torch.data.volumes import (
    AUG_FOLDERS,
    Manifest,
    SplitArrays,
    _as_manifest,
    load_split,
)
from vit3d_ensemble_tpu_torch.models.vit3d import resolve_device


def bootstrap_resample(manifest: Union[Manifest, str], seed: int) -> Manifest:
    """Seeded resample-with-replacement: the rows of `tools.py:137-147`.

    Pandas draws `df.sample(n, replace=True, random_state=seed)`'s positions
    as `np.random.RandomState(seed).choice(n, size=n, replace=True)`
    (`pandas/core/sample.py`); the same call picks the same rows here."""
    df = _as_manifest(manifest)
    n = len(df)
    return df.take(np.random.RandomState(seed).choice(n, size=n, replace=True))


def _append_disk_augmentation(train: SplitArrays, df: Manifest,
                              data_root: str, size: int) -> SplitArrays:
    """Append rotation/vflip/hflip variants of every 3rd HG item, from the
    precomputed on-disk folders (the reference loaders' data)."""
    hg_positions = np.flatnonzero(train.labels == 1)
    positions = hg_positions[::3]
    if len(positions) == 0:
        return train
    parts = [train]
    sub = df.take(positions)
    for aug in AUG_FOLDERS:
        parts.append(load_split(sub, data_root, aug_folder=aug, size=size))
    return SplitArrays.concat(parts)


def _append_device_augmentation(train: SplitArrays, seed: int,
                                device=None) -> SplitArrays:
    """Same policy, the variants computed on `device` (`data/augment.py`),
    the angles drawn from a generator there seeded with `seed`."""
    hg_positions = np.flatnonzero(train.labels == 1)
    positions = hg_positions[::3]
    if len(positions) == 0:
        return train
    device = resolve_device(device)
    src = train.subset(positions)
    gen = torch.Generator(device=device).manual_seed(seed)
    aug = augment_batch(torch.from_numpy(src.volumes).to(device), gen).cpu().numpy()
    parts = [train]
    for k in range(3):
        parts.append(dataclasses.replace(
            src, volumes=aug[k],
            patients=list(src.patients), zones=list(src.zones)))
    return SplitArrays.concat(parts)


def build_train_val(
    train_manifest: Union[Manifest, str],
    val_manifest: Union[Manifest, str],
    data_root: str,
    aug_mode: str = "disk",          # 'disk' | 'device' | 'none'
    size: int = 128,
    aug_seed: int = 42,
    device=None,
) -> Tuple[SplitArrays, SplitArrays, float]:
    """Assemble a normalized (train, val) pair.

    Returns (train, val, mean) with mean the scalar train-mean subtracted
    from both splits (computed pre-augmentation, like
    `utils/data_utils_cv.py:26-27`).  `device` is where 'device'
    augmentation runs (CUDA unless the caller names another).
    """
    train_df = _as_manifest(train_manifest)
    train = load_split(train_df, data_root, size=size)
    val = load_split(val_manifest, data_root, size=size)

    # float64 accumulation on the host, to match np.mean over the
    # reference's float64 volumes exactly (`pipeline.py:104-106`)
    mean = float(np.mean(train.volumes, dtype=np.float64))

    if aug_mode == "disk":
        train = _append_disk_augmentation(train, train_df, data_root, size)
    elif aug_mode == "device":
        train = _append_device_augmentation(train, aug_seed, device)
    elif aug_mode != "none":
        raise ValueError(f"unknown aug_mode: {aug_mode!r}")

    train = dataclasses.replace(train, volumes=train.volumes - np.float32(mean))
    val = dataclasses.replace(val, volumes=val.volumes - np.float32(mean))
    return train, val, mean


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
