"""The reference's optimizers, which the JAX package's optax chains mirror
(`vit3d_ensemble_tpu/train/optim.py:1-30`).

* `sgd_momentum` — torch.optim.SGD(lr, momentum=0.9, weight_decay) as used
  by the baseline trainers (`train_baseline_cv.py:111-114`), with the
  schedule as a LambdaLR over it.
* `adam` — torch.optim.Adam(lr=1e-4) as used by the ensemble trainers
  (`train_ensemble_cv.py:83`).
* `StackedAdam` — the same update over stacked tensors whose leading axes
  are independent instances, each with a step count of its own: the
  padded (combination, fold) grid (`sweep/e2e_grid.py`) and the frozen
  meta-head sweep (`sweep/ensemble_sweep.py`), where optax keeps one count
  a vmapped instance.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence, Tuple

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


class StackedAdam:
    """`torch.optim.Adam`'s update over stacked tensors with a step count
    for each instance.

    Every tensor's leading axes are `instances` (one per independent run).
    `torch.optim.Adam` keeps one scalar step a tensor, so a fully masked
    padding step of one instance would advance that instance's bias
    correction too.  Here the count has the instances' shape, and
    `step(valid)` advances, for the instances where `valid` is false,
    neither their parameters nor their two moments nor their count: they
    keep the bits they had (the JAX grid's no-op guard,
    `vit3d_ensemble_tpu/sweep/e2e_grid.py:275-286`).  `valid=None` (every
    instance stepped, the grid's uniform schedule) skips the guard; while
    every step has been such a step, the counts are one number and the
    update is `torch.optim.Adam`'s foreach form, a few multi-tensor
    launches for all the tensors.
    """

    def __init__(self, params: Sequence[torch.Tensor], learning_rate: float,
                 instances: Tuple[int, ...], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.instances = tuple(instances)
        self.exp_avg = [torch.zeros_like(p) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]
        self.count = torch.zeros(self.instances, dtype=torch.int64,
                                 device=self.params[0].device)
        #: the count every instance shares, on the host, until a guarded step
        self._shared_count: Optional[int] = 0

    def _lead(self, t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """t (instances) shaped to broadcast against `like`."""
        return t.reshape(self.instances + (1,) * (like.dim() - len(self.instances)))

    @torch.no_grad()
    def step(self, valid: Optional[torch.Tensor] = None) -> None:
        if valid is None and self._shared_count is not None:
            self._shared_step()
            return
        self._shared_count = None
        count = self.count + (1 if valid is None else valid.to(torch.int64))
        # the bias corrections in float64 and then float32, as torch.optim.Adam
        # forms them from Python floats
        t = count.clamp(min=1).to(torch.float64)
        step_size = (-self.lr / (1.0 - self.b1 ** t)).to(torch.float32)
        bc2_sqrt = torch.sqrt(1.0 - self.b2 ** t).to(torch.float32)
        for i, p in enumerate(self.params):
            g, m, v = p.grad, self.exp_avg[i], self.exp_avg_sq[i]
            m_new = torch.lerp(m, g, 1.0 - self.b1)
            v_new = torch.addcmul(v * self.b2, g, g, value=1.0 - self.b2)
            denom = v_new.sqrt() / self._lead(bc2_sqrt, p) + self.eps
            p_new = p + m_new * self._lead(step_size, p) / denom
            if valid is not None:
                keep = self._lead(valid, p)
                m_new = torch.where(keep, m_new, m)
                v_new = torch.where(keep, v_new, v)
                p_new = torch.where(keep, p_new, p)
            p.copy_(p_new)
            self.exp_avg[i], self.exp_avg_sq[i] = m_new, v_new
        self.count = count

    def _shared_step(self) -> None:
        """Every instance at the same count: `torch.optim.Adam`'s foreach
        update (`torch/optim/adam.py`, `_multi_tensor_adam`)."""
        self._shared_count += 1
        t = self._shared_count
        grads = [p.grad for p in self.params]
        torch._foreach_lerp_(self.exp_avg, grads, 1.0 - self.b1)
        torch._foreach_mul_(self.exp_avg_sq, self.b2)
        torch._foreach_addcmul_(self.exp_avg_sq, grads, grads, 1.0 - self.b2)
        denom = torch._foreach_sqrt(self.exp_avg_sq)
        torch._foreach_div_(denom, (1.0 - self.b2 ** t) ** 0.5)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_addcdiv_(self.params, self.exp_avg, denom,
                                -self.lr / (1.0 - self.b1 ** t))
        self.count += 1

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None
