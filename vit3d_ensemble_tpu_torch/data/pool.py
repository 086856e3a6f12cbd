"""Deduplicated volume pool: many folds/replicates over one array.

The counterpart of `vit3d_ensemble_tpu/data/pool.py`.  CV folds share
patients and bootstrap replicates are resamples of the same 81 training
rows (`tools.py:137-147`), so materializing each fold as its own array
duplicates volumes ~F times.  The pool keeps every unique (patient, z0,
lesion, aug_folder) volume exactly once, UN-normalized; a fold is an int32
row-index vector plus a scalar normalization mean, and the sweep engine
gathers and mean-centres on the device (`sweep/engine.py`).

Semantics of the reference loaders (`utils/data_utils*.py`): per-fold
scalar mean over the PRE-augmentation (or bootstrapped) trainset, taken in
float64 on the host from the per-row float64 means; the every-3rd-HG
augmentation append; validation normalized with the train mean.

'device' augmentation rows are flips of the original row (exact) and a
rotation by an angle fixed per lesion (`_stable_angle`); every rotation row
of a pool is computed in one batched call on the builder's device.
"""

from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Dict, List, Tuple

import numpy as np
import torch

from vit3d_ensemble_tpu_torch.data.augment import (
    ROTATION_RANGE_DEG,
    rotate_inplane,
)
from vit3d_ensemble_tpu_torch.data.pipeline import bootstrap_resample
from vit3d_ensemble_tpu_torch.data.volumes import (
    AUG_FOLDERS,
    Manifest,
    load_manifest,
    load_volume,
)
from vit3d_ensemble_tpu_torch.models.vit3d import resolve_device


@dataclasses.dataclass
class PooledSplit:
    """One fold's view into the pool."""

    row_idx: np.ndarray        # (N,) int32 rows into pool
    labels: np.ndarray         # (N,) float32
    mean: float                # scalar normalization mean (train mean)


@dataclasses.dataclass
class VolumePool:
    volumes: np.ndarray                      # (P, H, W, Z, C) float32, raw
    row_means: np.ndarray                    # (P,) float64 per-volume mean
    key_to_row: Dict[Tuple, int]

    def __len__(self) -> int:
        return self.volumes.shape[0]


def _stable_angle(seed: int, key: Tuple, lo: float, hi: float) -> float:
    """Per-(patient, z0, lesion) rotation angle, stable across folds and
    processes: the reference's precomputed 'rotation' folder likewise holds
    one fixed random rotation a patient, shared by every split that reads
    it.

    The hash is of `repr(key)`, so the key's values must have the types the
    JAX package's pandas manifests give them: `Manifest` reads an all-integer
    Lesion column as int, as `pd.read_csv` does; '1' or 1.0 would change the
    angle."""
    h = zlib.crc32(repr(key).encode())
    return float(np.random.default_rng((seed, h)).uniform(lo, hi))


class PoolBuilder:
    """Collects the unique volumes that the folds' manifests name.

    `device` is where the 'device' augmentation's rotation rows are computed
    (CUDA unless the caller names another); nothing else runs there."""

    def __init__(self, data_root: str, size: int = 128, device=None):
        self.data_root = data_root
        self.size = size
        self.device = device
        self._rows: List[np.ndarray] = []
        self._key_to_row: Dict[Tuple, int] = {}
        #: derived (device-augmented) rows: row -> (src_row, op, angle);
        #: placeholders in _rows until build()
        self._derived: Dict[int, Tuple[int, str, float]] = {}

    def row(self, patient: str, z0: int, lesion, aug_folder: str) -> int:
        key = (patient, int(z0), lesion, aug_folder)
        if key not in self._key_to_row:
            vol = load_volume(self.data_root, patient, int(z0), aug_folder,
                              self.size)
            self._key_to_row[key] = len(self._rows)
            self._rows.append(vol)
        return self._key_to_row[key]

    def device_aug_row(self, patient: str, z0: int, lesion, op: str,
                       aug_seed: int) -> int:
        """A row holding `op` applied on the device to the original volume;
        no disk folder is read.  op in AUG_FOLDERS; the transform runs
        batched in build()."""
        key = (patient, int(z0), lesion, f"device_{op}")
        if key not in self._key_to_row:
            src = self.row(patient, z0, lesion, "original")
            row = len(self._rows)
            self._key_to_row[key] = row
            self._rows.append(None)            # filled in build()
            angle = (_stable_angle(aug_seed, key[:3], *ROTATION_RANGE_DEG)
                     if op == "rotation" else 0.0)
            self._derived[row] = (src, op, angle)
        return self._key_to_row[key]

    def manifest_rows(self, df: Manifest,
                      aug_folder: str = "original") -> np.ndarray:
        return np.array([self.row(r.Patient, r.z0, r.Lesion, aug_folder)
                         for r in df.rows()], dtype=np.int32)

    def device_aug_manifest_rows(self, df: Manifest, op: str,
                                 aug_seed: int) -> np.ndarray:
        return np.array([self.device_aug_row(r.Patient, r.z0, r.Lesion, op,
                                             aug_seed)
                         for r in df.rows()], dtype=np.int32)

    def _fill_derived(self) -> None:
        if not self._derived:
            return
        rot = [(row, src, ang) for row, (src, op, ang)
               in self._derived.items() if op == "rotation"]
        for row, (src, op, _) in self._derived.items():
            if op == "vertical_flip":
                self._rows[row] = self._rows[src][::-1].copy()
            elif op == "horizontal_flip":
                self._rows[row] = self._rows[src][:, ::-1].copy()
        if rot:
            # one batched call on the device for every rotation row
            device = resolve_device(self.device)
            vols = torch.from_numpy(np.stack([self._rows[s] for _, s, _ in rot]))
            angles = torch.tensor([a for *_, a in rot], dtype=torch.float32)
            out = rotate_inplane(vols.to(device), angles.to(device)).cpu().numpy()
            for i, (row, _, _) in enumerate(rot):
                self._rows[row] = out[i]
        self._derived.clear()

    def build(self) -> VolumePool:
        self._fill_derived()
        vols = (np.stack(self._rows) if self._rows
                else np.zeros((0, self.size, self.size, 5, 1), np.float32))
        means = vols.reshape(len(self._rows), -1).mean(
            axis=1, dtype=np.float64) if self._rows else np.zeros(0)
        return VolumePool(vols, means, dict(self._key_to_row))


def manifest_labels(df: Manifest) -> np.ndarray:
    return np.array([0.0 if str(l) == "LG" else 1.0 for l in df["Label"]],
                    dtype=np.float32)


def pooled_train_split(builder: PoolBuilder, train_df: Manifest,
                       aug_mode: str = "disk", aug_seed: int = 42
                       ) -> Tuple[PooledSplit, np.ndarray]:
    """Trainset view: original rows + every-3rd-HG augmented rows; the mean
    over the pre-augmentation rows (`utils/data_utils_cv.py:26-40`).

    aug_mode 'disk' reads the precomputed folders; 'device' computes the
    same three variants on the device at pool-build time (no aug folders
    needed on disk); 'none' skips augmentation.
    """
    base_idx = builder.manifest_rows(train_df)
    labels = manifest_labels(train_df)
    # mean over pre-augmentation train rows (each volume the same size: the
    # mean of per-row means is the global scalar mean)
    mean_rows = base_idx

    idx_parts = [base_idx]
    label_parts = [labels]
    if aug_mode in ("disk", "device"):
        hg_positions = np.flatnonzero(labels == 1.0)
        positions = hg_positions[::3]
        if len(positions):
            sub = train_df.take(positions)
            for aug in AUG_FOLDERS:
                idx_parts.append(
                    builder.manifest_rows(sub, aug) if aug_mode == "disk"
                    else builder.device_aug_manifest_rows(sub, aug,
                                                          aug_seed))
                label_parts.append(manifest_labels(sub))
    elif aug_mode != "none":
        raise ValueError(f"pooled splits support aug_mode disk|device|none,"
                         f" got {aug_mode!r}")
    return PooledSplit(
        row_idx=np.concatenate(idx_parts),
        labels=np.concatenate(label_parts),
        mean=float("nan"),          # filled by finalize_mean
    ), mean_rows


def finalize_mean(pool: VolumePool, mean_rows: np.ndarray) -> float:
    return float(pool.row_means[mean_rows].mean()) if len(mean_rows) else 0.0


def _finalize(builder: PoolBuilder, folds):
    pool = builder.build()
    out = []
    for train, val, mean_rows in folds:
        mean = finalize_mean(pool, mean_rows)
        out.append((dataclasses.replace(train, mean=mean),
                    dataclasses.replace(val, mean=mean)))
    return pool, out


def _fold(builder: PoolBuilder, tdf: Manifest, vdf: Manifest, aug_mode: str,
          aug_seed: int):
    train, mean_rows = pooled_train_split(builder, tdf, aug_mode, aug_seed)
    val = PooledSplit(builder.manifest_rows(vdf), manifest_labels(vdf),
                      float("nan"))
    return train, val, mean_rows


def build_pooled_cv(csv_path: str, data_root: str, num_cv: int,
                    size: int = 128, aug_mode: str = "disk",
                    aug_seed: int = 42, device=None):
    """CV folds as pool views.  Returns (pool, [(train, val), ...])."""
    builder = PoolBuilder(data_root, size, device)
    folds = [_fold(builder,
                   load_manifest(os.path.join(csv_path, f"training_cv{cv + 1}.csv")),
                   load_manifest(os.path.join(csv_path, f"validation_cv{cv + 1}.csv")),
                   aug_mode, aug_seed)
             for cv in range(num_cv)]
    return _finalize(builder, folds)


def build_pooled_fixed(train_csv: str, val_csv: str, data_root: str,
                       size: int = 128, aug_mode: str = "disk",
                       aug_seed: int = 42, device=None):
    """The fixed split as a 1-fold pool view (whole-dataset training)."""
    builder = PoolBuilder(data_root, size, device)
    return _finalize(builder, [_fold(builder, load_manifest(train_csv),
                                     load_manifest(val_csv), aug_mode,
                                     aug_seed)])


def build_pooled_bootstrap(train_csv: str, val_csv: str, data_root: str,
                           num_rep: int, size: int = 128,
                           aug_mode: str = "disk", seed0: int = 0,
                           aug_seed: int = 42, device=None):
    """Bootstrap replicates as pool views (`utils/data_utils_bootstrap.py`):
    replicate k resamples training.csv with seed seed0 + k
    (`train_baseline_bootstrap.py:163`); validation is the fixed split,
    re-normalized with each replicate's mean."""
    builder = PoolBuilder(data_root, size, device)
    tdf_base = load_manifest(train_csv)
    vdf = load_manifest(val_csv)
    folds = [_fold(builder, bootstrap_resample(tdf_base, seed0 + rep), vdf,
                   aug_mode, aug_seed)
             for rep in range(num_rep)]
    return _finalize(builder, folds)
