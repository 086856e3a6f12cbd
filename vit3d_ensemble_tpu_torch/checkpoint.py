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
    weight.  A hybrid model's ResNetV2 stem
    (`embeddings/hybrid_model/resnet/...`) goes to the reference's names,
    `transformer.embeddings.hybrid_model.root.{conv,gn}` and
    `...hybrid_model.body.block{s}.unit{u}.{conv1,gn1,conv2,gn2,conv3,gn3,
    downsample,gn_proj}` (`models/resnet_hybrid.py`).
  * `ensemble_state_from_flax` inverts the prefixing of
    `torch_ensemble_to_flax` (`checkpoint.py:219-234`): `transformer_{i}`
    -> `transformers.{i}.`, and `meta/classifier` -> `classifier.*`.

  * `save_state_dict` writes a `state_dict` with `torch.save`, atomically,
    as the trainers' `save_path` does; `baseline_ckpt_path` and
    `ensemble_ckpt_path` name the files in the reference's layout, with its
    `.bin` extension; `load_baseline_params` reads a baseline's `.bin` back
    as an ensemble member's parameters.
  * `save_train_state` / `restore_train_state` keep a whole train state
    (parameters, optimizer state, step, run metadata), as the JAX
    package's do (`checkpoint.py:73-100`).

Reading the JAX package's msgpack checkpoints is not ported: the port
writes and reads `.bin` state dicts, which the JAX package also reads
(`checkpoint.load_baseline_params`, `checkpoint.py:109-110`).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from vit3d_ensemble_tpu_torch.configs import ViTConfig
from vit3d_ensemble_tpu_torch.models.vit3d import VisionTransformer3D
from vit3d_ensemble_tpu_torch.parallel.mesh import is_writer


def save_state_dict(path: str, state: Mapping[str, torch.Tensor]) -> None:
    """`torch.save` of CPU copies of `state` through a temporary file and a
    rename, so a preempted write never leaves a truncated checkpoint (the
    contract of the JAX package's `save_pytree`, `checkpoint.py:37-47`).

    Each tensor is copied into storage of its own: `torch.save` writes a
    view's whole storage, so a sweep member's slice of its group's stacked
    parameters would otherwise carry every cell of the group.  In a process
    group only rank 0 writes (`parallel/mesh.is_writer`)."""
    if not is_writer():
        return
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


def ensemble_ckpt_path(output_dir: str, kind: str, name: str, tag: str) -> str:
    """The ensembles' layout (`checkpoint.ensemble_ckpt_path`,
    `checkpoint.py:66-70`), with the `.bin` extension.

    kind: 'cv_ensemble' | 'bootstrap_ensemble' | 'best_ensemble'
    name: the members' confs joined by '_', e.g. '5_9_11'
    """
    return os.path.join(output_dir, f"{kind}_models", f"ensemble_{name}",
                        f"{tag}.bin")


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A `torch.save`d state_dict, on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def load_baseline_params(path: str, config: ViTConfig) -> Dict[str, torch.Tensor]:
    """A baseline's `.bin` checkpoint (the reference's torch names, as the
    port's drivers and the reference write it) as the parameters of a
    member of `config`: exactly that model's names and shapes, or a
    ValueError."""
    if not path.endswith(".bin"):
        raise ValueError(f"{path}: the port reads .bin state dicts only; the "
                         "JAX package's msgpack checkpoints are not ported")
    state = load_state_dict(path)
    with torch.device("meta"):
        want = {k: v.shape for k, v in VisionTransformer3D(
            config, device="meta").state_dict().items()}
    got = {k: v.shape for k, v in state.items()}
    if got != want:
        raise ValueError(
            f"{path}: not a checkpoint of this config: missing "
            f"{sorted(set(want) - set(got))}, unexpected "
            f"{sorted(set(got) - set(want))}, other shapes "
            f"{sorted(k for k in set(got) & set(want) if got[k] != want[k])}")
    return state


def _on_cpu(tree):
    """A copy of a nested state (dicts, lists, tuples of tensors and
    numbers) with every tensor in CPU storage of its own."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _on_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_on_cpu(v) for v in tree)
    return tree


def save_train_state(path: str, params: Mapping[str, torch.Tensor],
                     opt_state: Mapping[str, Any], step: int,
                     meta: Optional[Mapping[str, Any]] = None) -> None:
    """A whole train state (`checkpoint.save_train_state`,
    `checkpoint.py:73-87`): the parameters (a state_dict), the optimizer's
    `state_dict()`, the step and run metadata, by `torch.save` through a
    temporary file and a rename."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save({"params": _on_cpu(dict(params)), "opt_state": _on_cpu(dict(opt_state)),
                "step": int(step), "meta": dict(meta or {})}, tmp)
    os.replace(tmp, path)


def restore_train_state(path: str, params_target: Mapping[str, torch.Tensor],
                        opt_state_target: Mapping[str, Any]):
    """Restore a `save_train_state` snapshot (`checkpoint.py:90-99`) as
    (params, opt_state, step, meta).  The targets (a fresh model's and
    optimizer's state_dicts) give the names and shapes the snapshot must
    have; a snapshot of another model or optimizer raises ValueError."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    params, opt_state = raw["params"], raw["opt_state"]
    if ({k: v.shape for k, v in params.items()}
            != {k: v.shape for k, v in params_target.items()}):
        raise ValueError(f"{path}: the parameters are not the target's")
    if (len(opt_state.get("param_groups", ())) != len(opt_state_target.get(
            "param_groups", ())) or [len(g["params"]) for g in opt_state["param_groups"]]
            != [len(g["params"]) for g in opt_state_target["param_groups"]]):
        raise ValueError(f"{path}: the optimizer state is not the target's")
    return params, opt_state, int(raw["step"]), raw.get("meta", {})


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _resnet_state_from_flax(params: Mapping[str, Any],
                            prefix: str) -> Dict[str, torch.Tensor]:
    """The JAX package's ResNetV2 params -> the reference's torch names
    (`models/resnet_hybrid.py`): `root_conv` -> `root.conv`, `root_gn` ->
    `root.gn`, `block{s}_unit{u}/{conv1,gn1,...,gn_proj}` ->
    `body.block{s}.unit{u}.{conv1,gn1,...,gn_proj}`; (kh, kw, in, out)
    conv kernels become (out, in, kh, kw) weights and GroupNorm's
    `scale`/`bias` its `weight`/`bias`."""
    out: Dict[str, torch.Tensor] = {}

    def module(name, p):
        if "kernel" in p:
            out[f"{prefix}{name}.weight"] = _t(
                np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
        else:
            out[f"{prefix}{name}.weight"] = _t(p["scale"])
            out[f"{prefix}{name}.bias"] = _t(p["bias"])

    for key, p in params.items():
        if key in ("root_conv", "root_gn"):
            module(key.replace("_", "."), p)
        else:
            block, unit = key.split("_")
            for name, q in p.items():
                module(f"body.{block}.{unit}.{name}", q)
    return out


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
    if "hybrid_model" in emb:
        out.update(_resnet_state_from_flax(emb["hybrid_model"]["resnet"],
                                           f"{root}.hybrid_model."))
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
