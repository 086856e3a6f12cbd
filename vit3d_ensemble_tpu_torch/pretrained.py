"""Import original Google ViT (JAX) npz checkpoints into the port's 3D model.

The port's own copy of `vit3d_ensemble_tpu/pretrained.py` (the reference's
`np2th`, `Block.load_from` and `VisionTransformer.load_from`,
`models/modeling.py:41-45,199-234,291-344`): given the `vision_transformer`
repo's npz weights, build a `state_dict` of `VisionTransformer3D` (the
reference's torch names) with

  * q/k/v kernels (D, H, hd) and the out kernel (H, hd, D) reshaped to
    (D, D) and transposed to torch's (out, in); dense kernels transposed;
    LayerNorm `scale` as `weight`;
  * the 2D (ps, ps, C, D) patch kernel placed at z-slice kz // 2 of a zero
    (D, C, kh, kw, kz) Conv3d weight, so the initial response is the 2D
    model's on the centre slice;
  * the position table re-gridded to the config's token count (bilinear
    zoom over the 2D patch grid, `modeling.py:306-329`), CLS kept;
  * with `zero_head`, a zero head instead of the npz's.

Two limits are the JAX package's and kept: the channel count comes from the
npz kernel (an RGB checkpoint needs `in_channels=3`), and `resample_posemb`
takes the square root of the new token count, so a target with more than
one patch along z gets a table of the wrong length.  A hybrid config has no
npz counterpart for its stem and raises.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from vit3d_ensemble_tpu_torch.checkpoint import _t
from vit3d_ensemble_tpu_torch.configs import ViTConfig

ATTENTION_Q = "MultiHeadDotProductAttention_1/query"
ATTENTION_K = "MultiHeadDotProductAttention_1/key"
ATTENTION_V = "MultiHeadDotProductAttention_1/value"
ATTENTION_OUT = "MultiHeadDotProductAttention_1/out"
FC_0 = "MlpBlock_3/Dense_0"
FC_1 = "MlpBlock_3/Dense_1"
ATTENTION_NORM = "LayerNorm_0"
MLP_NORM = "LayerNorm_2"


def resample_posemb(posemb: np.ndarray, ntok_new: int,
                    has_cls: bool = True) -> np.ndarray:
    """Bilinear re-grid of a (1, T, D) position embedding to ntok_new tokens
    (`modeling.py:311-329`)."""
    from scipy import ndimage

    if posemb.shape[1] == ntok_new:
        return posemb
    if has_cls:
        tok, grid = posemb[:, :1], posemb[0, 1:]
        ntok_grid = ntok_new - 1
    else:
        tok, grid = posemb[:, :0], posemb[0]
        ntok_grid = ntok_new
    gs_old = int(np.sqrt(len(grid)))
    gs_new = int(np.sqrt(ntok_grid))
    grid = grid.reshape(gs_old, gs_old, -1)
    zoom = (gs_new / gs_old, gs_new / gs_old, 1)
    grid = ndimage.zoom(grid, zoom, order=1)
    grid = grid.reshape(1, gs_new * gs_new, -1)
    return np.concatenate([tok, grid], axis=1)


def load_from_npz(weights: Mapping[str, np.ndarray], config: ViTConfig,
                  zero_head: bool = True) -> Dict[str, torch.Tensor]:
    """A `VisionTransformer3D` state_dict from a Google-ViT npz mapping."""
    if config.hybrid_grid is not None:
        raise ValueError(
            "load_from_npz takes a pure-patchify config: a Google-ViT npz "
            "holds no weights for the hybrid ResNetV2 stem (hybrid_grid="
            f"{config.hybrid_grid})")
    D, nc = config.hidden_size, config.num_classes
    g = lambda k: np.asarray(weights[k])  # noqa: E731
    out: Dict[str, torch.Tensor] = {}

    emb = "transformer.embeddings"
    kernel_2d = g("embedding/kernel")                  # (ps, ps, C, D)
    kh, kw, kz = config.patch_size
    weight = np.zeros((D, kernel_2d.shape[2], kh, kw, kz), np.float32)
    weight[..., kz // 2] = kernel_2d.transpose(3, 2, 0, 1)
    out[f"{emb}.patch_embeddings.weight"] = _t(weight)
    out[f"{emb}.patch_embeddings.bias"] = _t(g("embedding/bias"))
    out[f"{emb}.cls_token"] = _t(g("cls"))
    out[f"{emb}.position_embeddings"] = _t(resample_posemb(
        g("Transformer/posembed_input/pos_embedding"), config.seq_len,
        has_cls=(config.classifier == "token")))

    for i in range(config.num_layers):
        src = f"Transformer/encoderblock_{i}"
        dst = f"transformer.encoder.layer.{i}"
        for name, key in (("attention_norm", ATTENTION_NORM),
                          ("ffn_norm", MLP_NORM)):
            out[f"{dst}.{name}.weight"] = _t(g(f"{src}/{key}/scale"))
            out[f"{dst}.{name}.bias"] = _t(g(f"{src}/{key}/bias"))
        for name, key in (("query", ATTENTION_Q), ("key", ATTENTION_K),
                          ("value", ATTENTION_V)):
            out[f"{dst}.attn.{name}.weight"] = _t(
                g(f"{src}/{key}/kernel").reshape(D, D).T)
            out[f"{dst}.attn.{name}.bias"] = _t(g(f"{src}/{key}/bias").reshape(D))
        out[f"{dst}.attn.out.weight"] = _t(
            g(f"{src}/{ATTENTION_OUT}/kernel").reshape(D, D).T)
        out[f"{dst}.attn.out.bias"] = _t(g(f"{src}/{ATTENTION_OUT}/bias"))
        for name, key in (("fc1", FC_0), ("fc2", FC_1)):
            out[f"{dst}.ffn.{name}.weight"] = _t(g(f"{src}/{key}/kernel").T)
            out[f"{dst}.ffn.{name}.bias"] = _t(g(f"{src}/{key}/bias"))

    norm = "transformer.encoder.encoder_norm"
    out[f"{norm}.weight"] = _t(g("Transformer/encoder_norm/scale"))
    out[f"{norm}.bias"] = _t(g("Transformer/encoder_norm/bias"))
    if zero_head:
        out["head.weight"] = torch.zeros(nc, D)
        out["head.bias"] = torch.zeros(nc)
    else:
        out["head.weight"] = _t(g("head/kernel").reshape(D, nc).T)
        out["head.bias"] = _t(g("head/bias").reshape(nc))
    return out
