"""Weight conversion from the JAX package's parameter trees to this port.

The JAX package's parameters cross over here: nested dicts of arrays, as
`jax.device_get(params)` gives them (anything `numpy.asarray` reads).  The
result is a `state_dict` of this port's modules, which use the reference's
torch names.

  * `vit_state_from_flax` mirrors `checkpoint.flax_vit_to_numpy_state`
    (`vit3d_ensemble_tpu/checkpoint.py:244-280`): the encoder's stacked
    layer axis is split per layer, (D, H, hd) QKV kernels become (D, D)
    torch weights, (in, out) dense kernels are transposed, and the
    (kh, kw, kz, C, D) patch kernel becomes the (D, C, kh, kw, kz) Conv3d
    weight.
  * `ensemble_state_from_flax` inverts the prefixing of
    `torch_ensemble_to_flax` (`checkpoint.py:219-234`): `transformer_{i}`
    -> `transformers.{i}.`, and `meta/classifier` -> `classifier.*`.

  * `save_state_dict` writes a `state_dict` with `torch.save`, atomically,
    as the trainers' `save_path` does; `baseline_ckpt_path` names the
    per-(conf, fold) files of the sweep in the reference's layout.

Reading the JAX package's msgpack checkpoints is not ported yet.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch

from vit3d_ensemble_tpu_torch.configs import ViTConfig


def save_state_dict(path: str, state: Mapping[str, torch.Tensor]) -> None:
    """`torch.save` of CPU copies of `state` through a temporary file and a
    rename, so a preempted write never leaves a truncated checkpoint (the
    contract of the JAX package's `save_pytree`, `checkpoint.py:37-47`).

    Each tensor is copied into storage of its own: `torch.save` writes a
    view's whole storage, so a sweep member's slice of its group's stacked
    parameters would otherwise carry every cell of the group."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save({k: v.detach().to("cpu", copy=True) for k, v in state.items()},
               tmp)
    os.replace(tmp, path)


def baseline_ckpt_path(output_dir: str, kind: str, conf: int, tag: str) -> str:
    """The reference's checkpoint layout (`checkpoint.baseline_ckpt_path`,
    `checkpoint.py:55-64`), with the reference's `.bin` extension for a
    `torch.save`d `state_dict` (`train_baseline_cv.py:128-134`).

    kind: 'baseline' | 'cv_baseline' | 'boot_baseline'
    tag:  e.g. 'conf5', 'cv1', 'boot17'
    """
    return os.path.join(output_dir, f"{kind}_models", f"conf{conf}",
                        f"{tag}.bin")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def vit_state_from_flax(params: Mapping[str, Any], config: ViTConfig,
                        prefix: str = "") -> Dict[str, torch.Tensor]:
    """JAX `VisionTransformer3D` params -> this port's `state_dict`."""
    D = config.hidden_size
    out: Dict[str, torch.Tensor] = {}
    emb = params["embeddings"]
    root = f"{prefix}transformer.embeddings"
    out[f"{root}.patch_embeddings.weight"] = _t(
        np.asarray(emb["patch_embeddings"]["kernel"]).transpose(4, 3, 0, 1, 2))
    out[f"{root}.patch_embeddings.bias"] = _t(emb["patch_embeddings"]["bias"])
    out[f"{root}.cls_token"] = _t(emb["cls_token"])
    out[f"{root}.position_embeddings"] = _t(emb["position_embeddings"])
    blk = params["encoder"]["layers"]["block"]

    def layer(tree, i):
        return np.asarray(tree)[i]

    for i in range(config.num_layers):
        root = f"{prefix}transformer.encoder.layer.{i}"
        for norm in ("attention_norm", "ffn_norm"):
            out[f"{root}.{norm}.weight"] = _t(layer(blk[norm]["scale"], i))
            out[f"{root}.{norm}.bias"] = _t(layer(blk[norm]["bias"], i))
        for name in ("query", "key", "value"):
            p = blk["attn"][name]
            out[f"{root}.attn.{name}.weight"] = _t(
                layer(p["kernel"], i).reshape(D, D).T)
            out[f"{root}.attn.{name}.bias"] = _t(layer(p["bias"], i).reshape(D))
        dense = {"attn.out": blk["attn"]["out"], "ffn.fc1": blk["ffn"]["fc1"],
                 "ffn.fc2": blk["ffn"]["fc2"]}
        for name, p in dense.items():
            out[f"{root}.{name}.weight"] = _t(layer(p["kernel"], i).T)
            out[f"{root}.{name}.bias"] = _t(layer(p["bias"], i))
    norm = params["encoder"]["encoder_norm"]
    out[f"{prefix}transformer.encoder.encoder_norm.weight"] = _t(norm["scale"])
    out[f"{prefix}transformer.encoder.encoder_norm.bias"] = _t(norm["bias"])
    out[f"{prefix}head.weight"] = _t(np.asarray(params["head"]["kernel"]).T)
    out[f"{prefix}head.bias"] = _t(params["head"]["bias"])
    return out


def ensemble_state_from_flax(params: Mapping[str, Any],
                             configs: Sequence[ViTConfig]
                             ) -> Dict[str, torch.Tensor]:
    """JAX `TransformerEnsemble` params -> this port's `state_dict`."""
    out: Dict[str, torch.Tensor] = {}
    for i, cfg in enumerate(configs):
        out.update(vit_state_from_flax(params[f"transformer_{i}"], cfg,
                                       prefix=f"transformers.{i}."))
    head = params["meta"]["classifier"]
    out["classifier.weight"] = _t(np.asarray(head["kernel"]).T)
    out["classifier.bias"] = _t(head["bias"])
    return out
