"""The reference's optimizers, which the JAX package's optax chains mirror
(`vit3d_ensemble_tpu/train/optim.py:1-30`).

* `sgd_momentum` — torch.optim.SGD(lr, momentum=0.9, weight_decay) as used
  by the baseline trainers (`train_baseline_cv.py:111-114`), with the
  schedule as a LambdaLR over it.
* `adam` — torch.optim.Adam(lr=1e-4) as used by the ensemble trainers
  (`train_ensemble_cv.py:83`).
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch
from torch.optim.lr_scheduler import LambdaLR

from vit3d_ensemble_tpu_torch.train.schedules import Factor


def sgd_momentum(params: Iterable[torch.nn.Parameter], learning_rate: float,
                 factor: Factor, momentum: float = 0.9,
                 weight_decay: float = 1e-2
                 ) -> Tuple[torch.optim.SGD, LambdaLR]:
    """SGD with weight decay added to the gradient before the momentum
    buffer (d = g + wd*p; buf = mu*buf + d; p -= lr(g)*buf), and the LambdaLR
    that sets lr(g) = learning_rate * factor(g) for the g-th update."""
    opt = torch.optim.SGD(params, lr=learning_rate, momentum=momentum,
                          weight_decay=weight_decay)
    return opt, LambdaLR(opt, factor)


def adam(params: Iterable[torch.nn.Parameter], learning_rate: float,
         b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8
         ) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=learning_rate, betas=(b1, b2), eps=eps)
