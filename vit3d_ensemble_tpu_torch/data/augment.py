"""The reference's three augmentations as tensor functions on the device.

The counterpart of `vit3d_ensemble_tpu/data/augment.py`.  The reference
ships three precomputed copies of every slice on disk ('rotation',
'vertical_flip', 'horizontal_flip'; `README.md:10-18`) and appends them to
the trainset (`utils/data_utils_cv.py:29-40`):

  * vertical_flip   == np.flipud (exact);
  * horizontal_flip == np.fliplr (exact);
  * rotation        == a random in-plane rotation by patient (roughly
                       +-30 deg, nearest neighbour).

These run on whatever device the volumes live on (the card, on the
drivers' path).  The rotation computes its source coordinates in float32,
as the JAX function does; where cos, sin or a fused multiply-add differ by
an ulp between devices, a coordinate at an exact .5 can round the other
way, so rotated volumes are compared by the share of differing pixels.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

#: Angle range (degrees) matching the observed spread of the reference's
#: precomputed rotation folders.
ROTATION_RANGE_DEG: Tuple[float, float] = (-30.0, 30.0)


def vertical_flip(vol: torch.Tensor) -> torch.Tensor:
    """np.flipud per slice: flip the H axis. vol: (..., H, W, Z, C)."""
    return torch.flip(vol, dims=(-4,))


def horizontal_flip(vol: torch.Tensor) -> torch.Tensor:
    """np.fliplr per slice: flip the W axis. vol: (..., H, W, Z, C)."""
    return torch.flip(vol, dims=(-3,))


def rotate_inplane(vol: torch.Tensor,
                   angle_deg: Union[torch.Tensor, float]) -> torch.Tensor:
    """In-plane (H, W) rotation by `angle_deg` about the image centre.

    For each output pixel, the source coordinate under the inverse rotation,
    rounded half to even to the nearest pixel and gathered, 0 where it falls
    outside.  vol: (..., H, W, Z, C); angle_deg: a number or a tensor of the
    leading shape (...), one angle a volume.
    """
    H, W = vol.shape[-4], vol.shape[-3]
    lead = vol.shape[:-4]
    angle = torch.as_tensor(angle_deg, dtype=torch.float32, device=vol.device)
    theta = (angle * (math.pi / 180.0)).reshape(*angle.shape, 1, 1)
    cos, sin = torch.cos(theta), torch.sin(theta)
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    yy = torch.arange(H, dtype=torch.float32, device=vol.device)[:, None] - cy
    xx = torch.arange(W, dtype=torch.float32, device=vol.device)[None, :] - cx
    # inverse map (rotate output grid by -theta into source space)
    src_y = cos * yy - sin * xx + cy
    src_x = sin * yy + cos * xx + cx
    iy = torch.round(src_y).to(torch.int64)
    ix = torch.round(src_x).to(torch.int64)
    valid = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
    flat = (iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1))
    flat = flat.expand(*lead, H, W).reshape(*lead, H * W)
    src = vol.reshape(*lead, H * W, *vol.shape[-2:])
    index = flat[..., None, None].expand(*lead, H * W, *vol.shape[-2:])
    gathered = torch.gather(src, -3, index).reshape(vol.shape)
    valid = valid.expand(*lead, H, W)[..., None, None]
    return torch.where(valid, gathered, torch.zeros((), dtype=vol.dtype,
                                                    device=vol.device))


def augment_batch(
    volumes: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    rotation_range: Tuple[float, float] = ROTATION_RANGE_DEG,
) -> torch.Tensor:
    """The reference's 3-variant augmentation of a batch, on its device.

    volumes: (N, H, W, Z, C).  Returns (3, N, H, W, Z, C) stacked
    [rotation, vertical_flip, horizontal_flip], the append order of
    `utils/data_utils_cv.py:30,37-40`.  The angles are drawn uniformly in
    `rotation_range` from `generator`, which must live on the volumes'
    device.
    """
    n = volumes.shape[0]
    lo, hi = rotation_range
    angles = torch.rand(n, generator=generator, device=volumes.device) * (hi - lo) + lo
    return torch.stack([rotate_inplane(volumes, angles),
                        vertical_flip(volumes), horizontal_flip(volumes)])
