"""Numbered baseline-ViT configuration registry (PyTorch port).

A copy of `vit3d_ensemble_tpu/configs.py`, kept in the port so that the
port imports nothing of the JAX package.  The two registries are held equal
by `tests/test_torch_configs.py`.

NOTE on reference defect D1 (SURVEY.md Appendix A): the reference's
`parameters_config` overwrites the same dict key inside its nested loops, so
every conf 1-18 collapses to (16, 3072, 8, 16, 16).  The README table is the
documented contract, so this registry implements the *intended* mapping:

    conf 1-18:  p=16, d in {2048, 3072} (outer), L in {4, 6, 8} (middle),
                (D, k) in {(64, 4), (32, 8), (16, 16)} (inner).
    conf 19-22: p=8, d=2204, L in {4, 6}, (D, k) in {(16, 4), (8, 8)}.

Set `collapsed=True` to reproduce the reference's *observed* (buggy) behavior
exactly, for defect-faithful comparisons.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Tuple

_MLP_DIMS = (2048, 3072)
_NUM_LAYERS = (4, 6, 8)
_HS_NH = ((64, 4), (32, 8), (16, 16))

_GRID_MAIN = {
    i + 1: (16, d, L, hs, nh)
    for i, (d, L, (hs, nh)) in enumerate(
        itertools.product(_MLP_DIMS, _NUM_LAYERS, _HS_NH)
    )
}
_GRID_SMALL = {
    i + 19: (8, 2204, L, hs, nh)
    for i, (L, (hs, nh)) in enumerate(
        itertools.product((4, 6), ((16, 4), (8, 8)))
    )
}
GRID = {**_GRID_MAIN, **_GRID_SMALL}

#: Configuration numbers of the 18 README baselines (the sweep set).
BASELINE_CONFS: Tuple[int, ...] = tuple(range(1, 19))

#: The paper's best-performing ensemble composition
#: (`train_ensemble_whole_dataset.py:199-200`).
BEST_ENSEMBLE: Tuple[int, int, int] = (5, 9, 11)


def parameters_config(conf: int, collapsed: bool = False):
    """conf number -> (patch_size, mlp_dim, num_layers, hidden_size, num_heads).

    Mirrors `tools.py:60-80`; `collapsed=True` reproduces defect D1's
    observed output instead of the intended README grid.
    """
    if collapsed:
        if 1 <= conf <= 18:
            return (16, 3072, 8, 16, 16)
        if 19 <= conf <= 26:
            return (8, 2204, 6, 8, 8)
        raise KeyError(f"Configuration {conf}")
    if conf not in GRID:
        raise KeyError(f"Configuration {conf}")
    return GRID[conf]


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Static hyperparameters of one 3D-ViT baseline (`tools.py:84-97`)."""

    patch_size: Tuple[int, int, int] = (16, 16, 5)
    hidden_size: int = 64
    mlp_dim: int = 2048
    num_heads: int = 4
    num_layers: int = 4
    attention_dropout_rate: float = 0.0
    dropout_rate: float = 0.1
    classifier: str = "token"
    img_size: int = 128
    z_size: int = 5          # volume depth (modeling.py:134 hard-codes 5)
    in_channels: int = 1
    num_classes: int = 1
    # hybrid ResNetV2 stem (reference `config.patches.grid` branch,
    # models/resnet_hybrid.py): the grid of tokens over the stem's features
    # a slice.  None = pure patchify (all README configs).
    hybrid_grid: Tuple[int, int] = None
    resnet_block_units: Tuple[int, ...] = (3, 4, 9)
    resnet_width_factor: int = 1

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def grid_shape(self) -> Tuple[int, int, int]:
        return (
            self.img_size // self.patch_size[0],
            self.img_size // self.patch_size[1],
            self.z_size // self.patch_size[2],
        )

    @property
    def n_patches(self) -> int:
        gh, gw, gz = self.grid_shape
        return gh * gw * gz

    @property
    def seq_len(self) -> int:
        return self.n_patches + 1  # + CLS token

    def forward_flops(self) -> int:
        """Analytical forward FLOPs per volume (matmul terms only; LN,
        softmax, GELU are bandwidth-bound and excluded)."""
        T = self.seq_len
        D = self.hidden_size
        per_layer = (8 * T * D * D          # QKV + out projections
                     + 4 * T * T * D        # scores + context (all heads)
                     + 4 * T * D * self.mlp_dim)   # fc1 + fc2
        embed = 2 * self.n_patches * D * (
            self.patch_size[0] * self.patch_size[1] * self.patch_size[2]
            * self.in_channels)
        return embed + self.num_layers * per_layer + 2 * D * self.num_classes

    @classmethod
    def from_conf(cls, conf: int, img_size: int = 128, **overrides) -> "ViTConfig":
        ps, dim, n, hs, nh = parameters_config(conf)
        return cls(
            patch_size=(ps, ps, 5),
            hidden_size=hs,
            mlp_dim=dim,
            num_heads=nh,
            num_layers=n,
            img_size=img_size,
            **overrides,
        )


def get_config(ps: int, dim: int, n: int, hs: int, nh: int,
               img_size: int = 128) -> ViTConfig:
    """Build a ViTConfig from raw grid values (mirrors `tools.py:84-97`)."""
    return ViTConfig(
        patch_size=(ps, ps, 5),
        hidden_size=hs,
        mlp_dim=dim,
        num_heads=nh,
        num_layers=n,
        img_size=img_size,
    )


def vit_b16_128cubed() -> ViTConfig:
    """The stretch configuration: 3D ViT-B/16 on full 128^3 volumes —
    (16,16,16) patches -> 8*8*8 = 512 tokens + CLS, ViT-B dimensions
    (D=768, 12 heads, mlp 3072, 12 layers), ~90M params.  Its attention
    (head_dim 64) needs the K4 kernel, which the port does not have yet.
    """
    return ViTConfig(
        patch_size=(16, 16, 16),
        hidden_size=768,
        mlp_dim=3072,
        num_heads=12,
        num_layers=12,
        img_size=128,
        z_size=128,
    )
