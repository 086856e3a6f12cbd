"""The ensemble's objective: torch.nn.BCELoss on sigmoid outputs
(`train_ensemble_cv.py:63,152`), over the valid rows of a padded batch, as
`vit3d_ensemble_tpu/train/ensemble_trainer.py:123-125` computes it."""

from __future__ import annotations

import torch


def masked_bce_on_probs(probs: torch.Tensor, labels: torch.Tensor,
                        mask: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Mean BCE on probabilities in [0, 1] over the rows where mask is 1."""
    pc = torch.clamp(probs.reshape(-1), eps, 1.0 - eps)
    labels = labels.reshape(-1).to(pc.dtype)
    per = -(labels * torch.log(pc) + (1.0 - labels) * torch.log(1.0 - pc))
    return torch.sum(per * mask) / torch.clamp(torch.sum(mask), min=1.0)
