"""Pre-activation ResNetV2 hybrid backbone in PyTorch, the counterpart of
`vit3d_ensemble_tpu/models/resnet_hybrid.py` (the reference's
`models/modeling_resnet.py:35-164`).

Weight-standardised convs, GroupNorm(32, eps 1e-6), pre-activation
bottlenecks, a 7x7/2 root conv with a 3x3/2 max-pool, and three stages of
`block_units` units scaled by `width_factor`.  `HybridBackbone3D` runs the
2D network on every z-slice of a (B, H, W, Z, C) volume with one set of
weights, as the JAX package's `nn.vmap` over depth does.

The convs, norms and the pool are library calls (`F.conv2d`,
`F.group_norm`, `F.max_pool2d`): the JAX package computes them outside any
Pallas kernel too.

Parameter names are the reference's torch names, so a reference
`state_dict` loads by name (under `transformer.embeddings.hybrid_model.`):

    root.conv.weight                     (64 wf, C, 7, 7)
    root.gn.weight, root.gn.bias
    body.block{s}.unit{u}.conv1.weight   1x1, cin -> cmid
    body.block{s}.unit{u}.gn1.{weight,bias}
    body.block{s}.unit{u}.conv2.weight   3x3, cmid -> cmid, the unit's stride
    body.block{s}.unit{u}.gn2.{weight,bias}
    body.block{s}.unit{u}.conv3.weight   1x1, cmid -> cout
    body.block{s}.unit{u}.gn3.{weight,bias}
    body.block{s}.unit{u}.downsample.weight   1x1, cin -> cout (projection)
    body.block{s}.unit{u}.gn_proj.{weight,bias}

with s and u counted from 1.  The JAX package names the same tensors
`resnet/root_conv`, `resnet/root_gn` and `resnet/block{s}_unit{u}/...`
(`checkpoint.vit_state_from_flax` carries them across).
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

#: Weight standardisation's epsilon (`resnet_hybrid.py:35`).
STD_EPS = 1e-5
#: GroupNorm's groups and epsilon (`resnet_hybrid.py:39-40`).
GN_GROUPS = 32
GN_EPS = 1e-6


def _lecun_normal_(w: torch.Tensor, g: torch.Generator) -> None:
    """flax's default conv kernel init: a normal truncated at 2 standard
    deviations, scaled to variance 1 / fan_in (fan_in = in * kh * kw)."""
    fan_in = w[0].numel()
    # the truncated normal's std is 0.8796 of its scale (flax's constant)
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)


class StdConv2d(nn.Conv2d):
    """A bias-free conv whose weight is standardised on every forward over
    (in, kh, kw): biased variance, (w - mean) / sqrt(var + 1e-5)
    (`resnet_hybrid.py:26-36`, `modeling_resnet.py:35-42`)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0):
        super().__init__(cin, cout, kernel, stride=stride, padding=padding,
                         bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var, mean = torch.var_mean(self.weight, dim=(1, 2, 3), keepdim=True,
                                   correction=0)
        w = (self.weight - mean) / torch.sqrt(var + STD_EPS)
        return F.conv2d(x, w, None, self.stride, self.padding)


def _gn(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(GN_GROUPS, channels, eps=GN_EPS)


class PreActBottleneck(nn.Module):
    """The (v2) bottleneck in the JAX package's order
    (`resnet_hybrid.py:43-67`): conv1 1x1 -> gn1 -> relu, conv2 3x3 with the
    stride -> gn2 -> relu, conv3 1x1 -> gn3; the residual is projected
    (1x1 conv with the stride -> gn_proj) where the stride or the width
    changes; out = relu(residual + y)."""

    def __init__(self, cin: int, cout: int, cmid: int, stride: int = 1):
        super().__init__()
        self.conv1 = StdConv2d(cin, cmid, 1)
        self.gn1 = _gn(cmid)
        self.conv2 = StdConv2d(cmid, cmid, 3, stride=stride, padding=1)
        self.gn2 = _gn(cmid)
        self.conv3 = StdConv2d(cmid, cout, 1)
        self.gn3 = _gn(cout)
        if stride != 1 or cin != cout:
            self.downsample = StdConv2d(cin, cout, 1, stride=stride)
            self.gn_proj = _gn(cout)
        else:
            self.downsample = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        if self.downsample is not None:
            residual = self.gn_proj(self.downsample(x))
        y = F.relu(self.gn1(self.conv1(x)))
        y = F.relu(self.gn2(self.conv2(y)))
        y = self.gn3(self.conv3(y))
        return F.relu(residual + y)


def stage_widths(block_units: Sequence[int], width_factor: int):
    """(cout, cmid, stride) of every unit, stage by stage: cout = 256 wf 2^s,
    cmid = 64 wf 2^s, stride 2 on the first unit of each stage after the
    first (`resnet_hybrid.py:83-92`)."""
    width = 64 * width_factor
    return [[(width * 4 * 2 ** s, width * 2 ** s, 2 if s > 0 and u == 0 else 1)
             for u in range(units)] for s, units in enumerate(block_units)]


class ResNetV2(nn.Module):
    """The 3-stage ResNetV2 feature extractor (`resnet_hybrid.py:70-95`) on
    (N, C, H, W) images."""

    def __init__(self, block_units: Sequence[int] = (3, 4, 9),
                 width_factor: int = 1, in_channels: int = 1):
        super().__init__()
        width = 64 * width_factor
        self.root = nn.Sequential(OrderedDict([
            ("conv", StdConv2d(in_channels, width, 7, stride=2, padding=3)),
            ("gn", _gn(width)),
            ("relu", nn.ReLU()),
            ("pool", nn.MaxPool2d(3, stride=2, padding=1)),
        ]))
        blocks, cin = [], width
        for s, units in enumerate(stage_widths(block_units, width_factor)):
            unit_list = []
            for u, (cout, cmid, stride) in enumerate(units):
                unit_list.append((f"unit{u + 1}",
                                  PreActBottleneck(cin, cout, cmid, stride)))
                cin = cout
            blocks.append((f"block{s + 1}", nn.Sequential(OrderedDict(unit_list))))
        self.body = nn.Sequential(OrderedDict(blocks))

    @torch.no_grad()
    def reset_parameters(self, g: torch.Generator) -> None:
        """flax's defaults: lecun-normal conv kernels, GroupNorm scale 1 and
        bias 0; drawn from `g` in module order."""
        for m in self.modules():
            if isinstance(m, StdConv2d):
                _lecun_normal_(m.weight, g)
            elif isinstance(m, nn.GroupNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(self.root(x))


class HybridBackbone3D(ResNetV2):
    """ResNetV2 on every z-slice of a (B, H, W, Z, C) volume, one set of
    weights, giving (B, H', W', Z, C') features (`resnet_hybrid.py:98-119`).

    Z is folded into the batch: GroupNorm's statistics are per sample, so
    this is exactly the JAX package's `nn.vmap` over depth."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, Z, C = x.shape
        x = x.permute(0, 3, 4, 1, 2).reshape(B * Z, C, H, W)
        f = super().forward(x)
        _, C2, H2, W2 = f.shape
        return f.view(B, Z, C2, H2, W2).permute(0, 3, 4, 1, 2)


def _conv_out(n: int, kernel: int, stride: int, padding: int) -> int:
    return (n + 2 * padding - kernel) // stride + 1


def feature_shape(img_size: int, block_units: Sequence[int],
                  width_factor: int) -> Tuple[int, int, int]:
    """(H', W', C') of the backbone's features for img_size x img_size
    slices, from the conv arithmetic: the root conv (7/2, pad 3), the pool
    (3/2, pad 1), and a 3x3/2 conv (pad 1) at each stage after the first."""
    h = _conv_out(_conv_out(img_size, 7, 2, 3), 3, 2, 1)
    channels = 64 * width_factor
    for units in stage_widths(block_units, width_factor):
        for channels, _, stride in units:
            h = _conv_out(h, 3, stride, 1)
    return h, h, channels
