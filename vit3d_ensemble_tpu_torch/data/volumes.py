"""Manifests and volume loading with the reference's slice-selection rules.

The counterpart of `vit3d_ensemble_tpu/data/volumes.py` (the reference's
`ProstateDataset`, `create_dataset.py:14-69`), without pandas or PIL, which
the card's host lacks:

  * manifest CSV columns: Patient, Label, Zone, GG, z0, Lesion
    (`csv_files/fixed_split/training.csv:1`), read by the `csv` module into
    a `Manifest` whose columns carry the types `pd.read_csv` infers;
  * per item: 5 consecutive PNG slices centred at the index derived from
    z0, into a (128, 128, 5, 1) HWZC volume;
  * slice order is REVERSED (real_z = n_slices - z0 + 1) for every patient
    except 'ProstateX-0179' (`create_dataset.py:41`);
  * filenames are '1-%02d.<ext>' (`create_dataset.py:42`);
  * the 5-slice window is clamped at the low end only:
    slices[max(0, idx-2) : idx+3] (`create_dataset.py:44`); windows running
    off the top of the stack leave trailing zero slices;
  * labels: 'LG' -> 0, anything else -> 1 (`create_dataset.py:62-63`);
  * optional Gaussian-noise OOD mode (`create_dataset.py:55-59`).

The slice listing is SORTED, as in the JAX package (the reference's
unsorted `os.listdir`, defect D13, SURVEY.md, makes the neighbourhood
arbitrary; '1-%02d' names sort correctly for the 18-25 slices a patient).

Each patient folder is decoded once and memoized process-wide: through the
native libpng decoder where it builds, else the stdlib decoder
(`data/native_loader.py`, `data/png.py`); `.npy` slices through `np.load`.
Any other file raises, where the JAX package would try PIL.
"""

from __future__ import annotations

import collections
import csv
import dataclasses
import functools
import os
import re
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np

from vit3d_ensemble_tpu_torch.data.native_loader import decode_batch
from vit3d_ensemble_tpu_torch.data.png import decode_gray8

MANIFEST_COLUMNS = ("Patient", "Label", "Zone", "GG", "z0", "Lesion")
#: The one patient whose slice files are already in anatomical order
#: (`create_dataset.py:41`).
UNREVERSED_PATIENT = "ProstateX-0179"
AUG_FOLDERS = ("rotation", "vertical_flip", "horizontal_flip")

#: Fields `pd.read_csv` reads as missing by default.
_NA = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN",
                 "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL",
                 "NaN", "None", "n/a", "nan", "null"})
_INT = re.compile(r"\s*[+-]?\d+\s*$")


def _is_float(s: str) -> bool:
    try:
        float(s)
    except ValueError:
        return False
    return True


def _typed(fields: Sequence[str]) -> list:
    """One column's values with the Python types that `pd.read_csv`
    followed by `itertuples` gives them: int for an all-integer column, float
    (NaN where missing) for a numeric one, else str (NaN where missing).

    The types matter beyond parsing: `PoolBuilder` keys its rows and hashes
    the device rotation's angle on `repr` of (patient, z0, lesion), so a
    Lesion of '1' or 1.0 where pandas gives 1 changes every angle."""
    present = [f for f in fields if f not in _NA]
    if present and len(present) == len(fields) and all(map(_INT.match, present)):
        return [int(f) for f in fields]
    if all(map(_is_float, present)):
        return [float(f) if f not in _NA else float("nan") for f in fields]
    return [f if f not in _NA else float("nan") for f in fields]


class Manifest:
    """A split CSV: named, typed columns with the rows in file order.

    The part of a pandas DataFrame the loaders use: `len()`, a column as a
    list (`m["Label"]`), `rows()` as `itertuples(index=False)` gives them,
    and `take(positions)`, which selects rows by position as `iloc` does.
    """

    def __init__(self, columns: Dict[str, list]):
        self.columns: Tuple[str, ...] = tuple(columns)
        self._data = {k: list(v) for k, v in columns.items()}
        lengths = {len(v) for v in self._data.values()}
        if len(lengths) > 1:
            raise ValueError(f"manifest columns of unequal lengths {lengths}")
        self._n = lengths.pop() if lengths else 0
        self._row = collections.namedtuple("Row", self.columns, rename=True)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, column: str) -> list:
        return list(self._data[column])

    def rows(self) -> Iterator[tuple]:
        for values in zip(*(self._data[c] for c in self.columns)):
            yield self._row(*values)

    def take(self, positions: Sequence[int]) -> "Manifest":
        idx = [int(i) for i in np.asarray(positions, dtype=np.int64).ravel()]
        return Manifest({c: [v[i] for i in idx] for c, v in self._data.items()})


def load_manifest(csv_path: str) -> Manifest:
    """Read a split CSV (schema above)."""
    with open(csv_path, newline="") as f:
        records = [r for r in csv.reader(f) if r]
    if not records:
        raise ValueError(f"{csv_path}: empty manifest")
    header, body = records[0], records[1:]
    body = [r + [""] * (len(header) - len(r)) for r in body]
    return Manifest({name: _typed([r[j] for r in body])
                     for j, name in enumerate(header)})


def _as_manifest(manifest: Union[Manifest, str]) -> Manifest:
    return load_manifest(manifest) if isinstance(manifest, str) else manifest


@functools.lru_cache(maxsize=4096)
def _patient_stack(data_root: str, patient: str, aug_folder: str,
                   size: int) -> Tuple[np.ndarray, Tuple[str, ...]]:
    """Decode & memoize one patient folder -> ((n_slices, H, W) uint8, names).

    A PNG folder is one call of the native decoder when it is available;
    otherwise, and for `.npy` slices, each file is read on its own."""
    folder = os.path.join(data_root, patient, aug_folder)
    names = tuple(sorted(os.listdir(folder)))
    paths = [os.path.join(folder, name) for name in names]

    if names and all(n.endswith(".png") for n in names):
        stack = decode_batch(paths, size)
        if stack is not None:
            return stack, names

    imgs = []
    for path in paths:
        if path.endswith(".npy"):
            imgs.append(np.load(path))
        elif path.endswith(".png"):
            imgs.append(decode_gray8(path))
        else:
            raise ValueError(f"slice {path} is neither a PNG nor a .npy file")
        if imgs[-1].shape[:2] != (size, size):
            raise ValueError(
                f"slice {path} is {imgs[-1].shape[:2]}, expected "
                f"({size}, {size})")
    return np.stack(imgs), names


def load_volume(
    data_root: str,
    patient: str,
    z0: int,
    aug_folder: str = "original",
    size: int = 128,
    ood: bool = False,
    ood_mean: float = 0.0,
    ood_var: float = 1.0,
    ood_rng: Optional[np.random.Generator] = None,
) -> np.ndarray:
    """One (size, size, 5, 1) float32 volume, reference slice semantics."""
    stack, names = _patient_stack(data_root, patient, aug_folder, size)
    n = len(names)
    real_z = z0 if patient == UNREVERSED_PATIENT else n - z0 + 1
    ext = names[0].rsplit(".", 1)[1]
    target = f"1-{real_z:02d}.{ext}"
    idx = names.index(target)
    lo = max(0, idx - 2)
    window = stack[lo: idx + 3]

    volume = np.zeros((size, size, 5, 1), dtype=np.float32)
    for k in range(window.shape[0]):
        v = window[k].astype(np.float32)
        if ood:
            rng = ood_rng or np.random.default_rng()
            v = v + rng.normal(ood_mean, ood_var, v.shape)
        volume[:, :, k, 0] = v
    return volume


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


def load_split(
    manifest: Union[Manifest, str],
    data_root: str,
    aug_folder: str = "original",
    size: int = 128,
    ood: bool = False,
    ood_mean: float = 0.0,
    ood_var: float = 1.0,
    ood_seed: Optional[int] = None,
) -> SplitArrays:
    """Load every row of a manifest into one SplitArrays."""
    df = _as_manifest(manifest)
    rng = np.random.default_rng(ood_seed) if ood else None
    volumes = np.stack([
        load_volume(data_root, row.Patient, int(row.z0), aug_folder, size,
                    ood=ood, ood_mean=ood_mean, ood_var=ood_var, ood_rng=rng)
        for row in df.rows()
    ]) if len(df) else np.zeros((0, size, size, 5, 1), np.float32)
    labels = np.array([0 if str(l) == "LG" else 1 for l in df["Label"]],
                      dtype=np.int32)
    return SplitArrays(
        volumes=volumes,
        labels=labels,
        patients=[str(p) for p in df["Patient"]],
        zones=[str(z) for z in df["Zone"]],
    )


def clear_volume_cache() -> None:
    _patient_stack.cache_clear()
