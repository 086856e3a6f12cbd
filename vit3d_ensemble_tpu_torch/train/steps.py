"""Step primitives shared by the trainers, and the evaluation steps.

The counterpart of `vit3d_ensemble_tpu/train/steps.py`.  The reference's
per-step host work (sklearn class weights, `.item()` syncs,
`train_baseline_cv.py:163-187`) is folded into tensor expressions:
pos_weight is closed-form and padded rows are masked, so a training step
never waits for the host.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def masked_balanced_pos_weight(labels: torch.Tensor,
                               mask: torch.Tensor) -> torch.Tensor:
    """Per-batch sklearn 'balanced' positive-class weight over valid rows
    (`train_baseline_cv.py:168-169`)."""
    y = labels.float() * mask
    n = torch.sum(mask)
    n_pos = torch.sum(y)
    n_neg = n - n_pos
    both = (n_pos > 0) & (n_neg > 0)
    return torch.where(both, n / (2.0 * torch.clamp(n_pos, min=1.0)),
                       torch.ones_like(n))


def masked_bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                           mask: torch.Tensor, pos_weight) -> torch.Tensor:
    """torch.nn.BCEWithLogitsLoss(pos_weight) over the valid rows: the mean
    of the per-example losses where mask is 1."""
    logits = logits.reshape(-1)
    labels = labels.reshape(-1).to(logits.dtype)
    per_example = -(pos_weight * labels * F.logsigmoid(logits)
                    + (1.0 - labels) * F.logsigmoid(-logits))
    return torch.sum(per_example * mask) / torch.clamp(torch.sum(mask), min=1.0)


@torch.no_grad()
def baseline_eval_step(model, vols: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(probs, cls_features) of one forward over the whole split:
    probs = sigmoid(logits) (`tools.py:50`), features = the CLS token
    (`train_baseline_cv.py:80`)."""
    out = model(vols, deterministic=True)
    return torch.sigmoid(out.logits.reshape(-1)), out.tokens[:, 0]


@torch.no_grad()
def ensemble_eval_step(model, vols: torch.Tensor,
                       member_masks=None) -> torch.Tensor:
    """The ensemble's probabilities (N,) in one forward."""
    return model(vols, deterministic=True,
                 member_masks=member_masks).reshape(-1)
