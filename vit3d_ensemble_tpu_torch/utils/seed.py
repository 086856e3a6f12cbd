"""Seeding / reproducibility (`tools.py:12-16` equivalent).

The counterpart of `vit3d_ensemble_tpu/utils/seed.py`: seeds the host-side
sources the port uses, python `random` and numpy's legacy global RNG, and
returns a `torch.Generator` seeded with the same number where the JAX
package returns a root key.  Batch shuffles use `np.random.default_rng(seed)`
instances and the trainers' dropout draws from generators they seed
themselves, all from the same --seed flag.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int = 42) -> torch.Generator:
    random.seed(seed)
    np.random.seed(seed)
    return torch.Generator().manual_seed(seed)
