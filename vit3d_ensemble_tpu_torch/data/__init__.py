"""Data subsystem: manifest CSVs and PNG folders -> dense volume arrays.

The counterpart of `vit3d_ensemble_tpu/data/`: splits are loaded once into
(N, 128, 128, 5, 1) float32 arrays (`volumes.py`), normalized and augmented
(`pipeline.py`, `augment.py`), or kept as views into one deduplicated pool
for the sweeps (`pool.py`).  CSVs are read with the `csv` module and PNGs
decoded by the native libpng loader or a stdlib fallback
(`native_loader.py`, `png.py`): no pandas or PIL.
"""

from vit3d_ensemble_tpu_torch.data.volumes import (  # noqa: F401
    Manifest,
    load_manifest,
    load_volume,
    load_split,
    SplitArrays,
)
from vit3d_ensemble_tpu_torch.data.pipeline import (  # noqa: F401
    build_train_val,
    bootstrap_resample,
    EpochBatcher,
)
from vit3d_ensemble_tpu_torch.data.augment import augment_batch  # noqa: F401
