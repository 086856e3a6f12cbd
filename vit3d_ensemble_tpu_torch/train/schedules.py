"""LR schedules matching `utils/scheduler.py:8-63`, as `LambdaLR` factors.

The reference implements torch LambdaLR multipliers; the JAX package
(`vit3d_ensemble_tpu/train/schedules.py`) turns them into optax schedules
(factor x base lr).  Here they are the factors again.  Step indexing is
torch's: the g-th optimizer update (g = 0, 1, ...) uses factor(g), so the
warmup schedules' first update is a zero-LR step.

`shift=1` reproduces reference defect D15 (`train_baseline_whole_dataset.py:
198-199`, bootstrap the same): those scripts call scheduler.step() BEFORE
optimizer.step(), off-by-one'ing the curve.  The CV script has the correct
order (`train_baseline_cv.py:180-181`), which is the default here.
"""

from __future__ import annotations

import math
from typing import Callable

Factor = Callable[[int], float]


def constant_factor() -> Factor:
    return lambda step: 1.0


def warmup_constant_factor(warmup_steps: int, shift: int = 0) -> Factor:
    def factor(count: int) -> float:
        step = count + shift
        return step / max(1.0, warmup_steps) if step < warmup_steps else 1.0

    return factor


def warmup_linear_factor(warmup_steps: int, t_total: int,
                         shift: int = 0) -> Factor:
    def factor(count: int) -> float:
        step = count + shift
        if step < warmup_steps:
            return step / max(1.0, warmup_steps)
        return max(0.0, (t_total - step) / max(1.0, t_total - warmup_steps))

    return factor


def warmup_cosine_factor(warmup_steps: int, t_total: int,
                         cycles: float = 0.5, shift: int = 0) -> Factor:
    """Reference default (decay_type='cosine', `train_baseline_cv.py:116-117`).

    NOTE: with the reference's default flags warmup_steps=1000 > t_total=100
    (defect D17), training never leaves the warmup ramp; the formula below
    reproduces that faithfully.
    """

    def factor(count: int) -> float:
        step = count + shift
        if step < warmup_steps:
            return step / max(1.0, warmup_steps)
        progress = (step - warmup_steps) / max(1.0, t_total - warmup_steps)
        return max(0.0, 0.5 * (1.0 + math.cos(math.pi * cycles * 2.0
                                              * progress)))

    return factor


def make_factor(decay_type: str, warmup_steps: int, t_total: int,
                shift: int = 0) -> Factor:
    """The factor of the reference's --decay_type flag."""
    if decay_type == "cosine":
        return warmup_cosine_factor(warmup_steps, t_total, shift=shift)
    if decay_type == "linear":
        return warmup_linear_factor(warmup_steps, t_total, shift=shift)
    if decay_type == "warmup_constant":
        return warmup_constant_factor(warmup_steps, shift=shift)
    if decay_type == "constant":
        return constant_factor()
    raise ValueError(f"unknown decay_type: {decay_type!r}")
