"""Shape-class grouping and stacked, padded parameter construction.

The counterpart of `vit3d_ensemble_tpu/sweep/stack.py`.  The 18 README
configs span 3 (hidden_size, num_heads) shape classes x {2048, 3072} MLP
widths x {4, 6, 8} depths.  Hidden size cannot be padded without changing
LayerNorm, so (D, k) defines the shape class; depth and MLP width are padded
to the class maximum with zeros and masked at run time (exact: see
`models/vit3d.py`).

Each group trains as one stacked model (`sweep/stacked.py`) over parameters
with leading axes (n_configs_in_group, n_folds).  Parameters are `state_dict`s
of the group's template model, under the reference's torch names.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Sequence, Tuple

import torch

from vit3d_ensemble_tpu_torch.configs import ViTConfig, parameters_config
from vit3d_ensemble_tpu_torch.models import VisionTransformer3D
from vit3d_ensemble_tpu_torch.train.trainer import init_baseline

State = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ConfigGroup:
    hidden_size: int
    num_heads: int
    confs: Tuple[int, ...]            # config numbers, length G
    mlp_dims: Tuple[int, ...]         # per conf
    num_layers: Tuple[int, ...]       # per conf
    #: every member's dropout (the configs' 0.1); 0 for runs held step for
    #: step against another trainer
    dropout_rate: float = 0.1

    @property
    def max_mlp(self) -> int:
        return max(self.mlp_dims)

    @property
    def max_layers(self) -> int:
        return max(self.num_layers)

    def template_config(self, img_size: int = 128) -> ViTConfig:
        """The padded architecture this group trains as."""
        return ViTConfig(
            patch_size=(16, 16, 5),
            hidden_size=self.hidden_size,
            mlp_dim=self.max_mlp,
            num_heads=self.num_heads,
            num_layers=self.max_layers,
            img_size=img_size,
            dropout_rate=self.dropout_rate,
        )

    def member_config(self, i: int, img_size: int = 128) -> ViTConfig:
        return ViTConfig.from_conf(self.confs[i], img_size=img_size,
                                   dropout_rate=self.dropout_rate)


def group_configs(confs: Sequence[int]) -> List[ConfigGroup]:
    """Partition config numbers into (hidden, heads) shape classes."""
    buckets: Dict[Tuple[int, int], List[int]] = {}
    for c in confs:
        ps, mlp, L, hs, nh = parameters_config(c)
        if ps != 16:
            raise ValueError(
                f"conf {c} uses patch {ps}; sweep groups assume the README "
                "16-patch grid")
        buckets.setdefault((hs, nh), []).append(c)
    groups = []
    for (hs, nh), members in sorted(buckets.items(), reverse=True):
        members = sorted(members)
        groups.append(ConfigGroup(
            hidden_size=hs,
            num_heads=nh,
            confs=tuple(members),
            mlp_dims=tuple(parameters_config(c)[1] for c in members),
            num_layers=tuple(parameters_config(c)[2] for c in members),
        ))
    return groups


def _pad_to(small: torch.Tensor, target_shape) -> torch.Tensor:
    """Zero-pad `small` up to target_shape (trailing-region padding)."""
    if tuple(small.shape) == tuple(target_shape):
        return small
    out = small.new_zeros(target_shape)
    out[tuple(slice(0, s) for s in small.shape)] = small
    return out


def _shapes(config: ViTConfig) -> Dict[str, torch.Size]:
    """The parameter shapes of a model of `config`, allocating nothing."""
    with torch.device("meta"):
        model = VisionTransformer3D(config, device="meta")
    return {k: v.shape for k, v in model.state_dict().items()}


def init_member_params(group: ConfigGroup, i: int, seed: int,
                       img_size: int = 128) -> State:
    """Member i's init with its true shapes (`init_baseline`, as its own
    run draws it), zero-padded to the group template, on the CPU.  Zero
    padding with the run-time masks keeps the padded regions exactly inert
    under SGD (their gradients are 0, and so is their weight decay);
    padded layers have zero LayerNorm scales, as in the JAX package."""
    state = init_baseline(group.member_config(i, img_size), seed,
                          device="cpu").state_dict()
    return {k: (_pad_to(state[k], shape) if k in state
                else torch.zeros(shape))
            for k, shape in _shapes(group.template_config(img_size)).items()}


def init_group_params(group: ConfigGroup, n_folds: int, seed: int,
                      img_size: int = 128, device=None) -> State:
    """Stacked parameters with leading axes (G, F) on `device` (the CPU
    when None).  The reference re-seeds identically before every fold's
    model (`train_baseline_cv.py:270-275`), so folds share their init: the
    fold axis repeats one init per config."""
    members = [init_member_params(group, i, seed, img_size)
               for i in range(len(group.confs))]
    out = {}
    for k in members[0]:
        stacked = torch.stack([m[k] for m in members]).to(device)
        out[k] = stacked.unsqueeze(1).expand(
            stacked.shape[0], n_folds, *stacked.shape[1:]).contiguous()
    return out


def unpad_group_params(padded: Mapping[str, torch.Tensor], group: ConfigGroup,
                       img_size: int = 128, lead_axes: int = 1) -> List[State]:
    """Every member's true-shape `state_dict` out of stacked padded params.

    padded: leading axes (G, *lead), e.g. (G, F) from the sweep engine.
    Returns G `state_dict`s on the CPU, each with the `lead_axes` leading
    axes kept (per fold) and the trailing dims cropped to the member's true
    shapes; the crop runs where the params live, so only true shapes move.
    """
    lead = (slice(None),) * lead_axes
    out = []
    for i in range(len(group.confs)):
        shapes = _shapes(group.member_config(i, img_size))
        out.append({k: padded[k][(i,) + lead + tuple(slice(0, s) for s in shape)]
                    .detach().contiguous().cpu()
                    for k, shape in shapes.items()})
    return out


def unpad_params(padded: Mapping[str, torch.Tensor], group: ConfigGroup,
                 i: int, img_size: int = 128) -> State:
    """Member i's true-shape `state_dict` out of one padded `state_dict`."""
    shapes = _shapes(group.member_config(i, img_size))
    return {k: padded[k][tuple(slice(0, s) for s in shape)]
            for k, shape in shapes.items()}
