"""Diagnostic toggles, the counterpart of `vit3d_ensemble_tpu/utils/debug.py`.

The JAX package turns on `jax_debug_nans`; the port turns on autograd's
anomaly detection, which raises on a NaN produced in any backward op and
names the forward op that made it.  This is what `--debug_nans` reaches.
"""

from __future__ import annotations

import torch


def enable_nan_checking() -> None:
    torch.autograd.set_detect_anomaly(True)


def disable_nan_checking() -> None:
    torch.autograd.set_detect_anomaly(False)
