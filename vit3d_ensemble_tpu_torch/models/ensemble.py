"""Stacking ensemble: N ViT backbones + Linear meta-classifier.

Counterpart of `vit3d_ensemble_tpu/models/ensemble.py` (the reference's
`TransformerEnsemble`, `models/modeling.py:347-356`): per-backbone CLS
logits are concatenated and fed to a Linear(N * num_classes, 1) + sigmoid
meta-classifier.

NOTE on reference defect D6 (SURVEY.md): the reference's default
`in_features=3` builds Linear(9, 1), which crashes on the (B, 3) concat; the
working head is Linear(N * num_classes, 1), which is what this module
builds.  Parameter names are the reference's: `transformers.{i}.*` and
`classifier.*`.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from vit3d_ensemble_tpu_torch.configs import ViTConfig
from vit3d_ensemble_tpu_torch.models.vit3d import (
    Active,
    VisionTransformer3D,
    resolve_device,
)


class MetaHead(nn.Linear):
    """Linear(N * num_classes, num_classes) + sigmoid (`modeling.py:351,356`)."""

    def __init__(self, n_members: int = 3, n_classes: int = 1, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(n_members * n_classes, n_classes)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        bound = 1.0 / math.sqrt(self.in_features)
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=g)
            self.bias.uniform_(-bound, bound, generator=g)

    def forward(self, member_logits: torch.Tensor) -> torch.Tensor:
        # member_logits: (B, N * num_classes)
        return torch.sigmoid(super().forward(member_logits))


class TransformerEnsemble(nn.Module):
    """End-to-end stacking ensemble over heterogeneous ViT configs.

    `member_masks` (optional, one (num_layers_active, mlp_active) pair per
    member) runs each member as a padded template with runtime depth and
    width masks, as the JAX sweep does.  Members and the head draw their
    parameters from one `generator` in order; the ensemble lives on
    `device`, CUDA unless the caller names another.  `remat` recomputes the
    members' encoder blocks in the backward pass (`ensemble.py:71,82`).
    """

    def __init__(self, configs: Sequence[ViTConfig], *, zero_head: bool = True,
                 device=None, generator: Optional[torch.Generator] = None,
                 remat: bool = False):
        super().__init__()
        device = resolve_device(device)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.configs: Tuple[ViTConfig, ...] = tuple(configs)
        self.transformers = nn.ModuleList(
            VisionTransformer3D(cfg, zero_head=zero_head, vis=False,
                                device="cpu", generator=g, remat=remat)
            for cfg in self.configs)
        self.classifier = MetaHead(len(self.configs),
                                   self.configs[0].num_classes, generator=g)
        self.to(device)

    def forward(self, x: torch.Tensor, *, deterministic: bool = True,
                member_masks: Optional[Sequence[Tuple[Optional[Active],
                                                      Optional[Active]]]] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: (B, H, W, Z, C) -> ensemble probability (B, num_classes)."""
        member_logits = []
        for i, member in enumerate(self.transformers):
            la, ml = (member_masks[i] if member_masks is not None
                      else (None, None))
            out = member(x, deterministic=deterministic, num_layers_active=la,
                         mlp_active=ml, generator=generator)
            member_logits.append(out.logits)
        return self.classifier(torch.cat(member_logits, dim=-1))
