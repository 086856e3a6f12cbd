"""End-to-end stacking-ensemble trainer (the reference-faithful mode).

The counterpart of `vit3d_ensemble_tpu/train/ensemble_trainer.py` (the
ensemble scripts' epoch loop, `train_ensemble_whole_dataset.py:31-186`,
`train_ensemble_cv.py:85-202`): backbones start from trained baseline
weights, the FULL ensemble (backbones + Linear meta head) is optimized with
Adam under BCELoss on the sigmoid output, evaluation runs after every epoch,
and the spec/sens > 0.6-then-AUROC rule selects the checkpoint.

Faithfulness notes:
  * backbones are NOT frozen (the reference optimizes
    `ensemble.parameters()`, `train_ensemble_cv.py:83`);
  * no augmentation in ensemble training (`train_ensemble_cv.py:97-107`);
  * the meta head is Linear(N * num_classes, 1) (defect D6).

The loop is eager Python over steps, like the baseline trainer's, and never
waits for the device until the run ends.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from vit3d_ensemble_tpu_torch.checkpoint import save_state_dict
from vit3d_ensemble_tpu_torch.configs import BASELINE_CONFS, ViTConfig, parameters_config
from vit3d_ensemble_tpu_torch.metrics import (
    METRIC_KEYS,
    compute_eval_metrics,
    metrics_vector,
)
from vit3d_ensemble_tpu_torch.models import TransformerEnsemble
from vit3d_ensemble_tpu_torch.models.ensemble import MetaHead
from vit3d_ensemble_tpu_torch.models.vit3d import resolve_device
from vit3d_ensemble_tpu_torch.sweep.stack import _pad_to, _shapes
from vit3d_ensemble_tpu_torch.train.losses import masked_bce_on_probs
from vit3d_ensemble_tpu_torch.train.optim import adam
from vit3d_ensemble_tpu_torch.train.selection import (
    BestTracker,
    device_best_init,
    device_consider,
    device_take_if,
)
from vit3d_ensemble_tpu_torch.train.steps import ensemble_eval_step
from vit3d_ensemble_tpu_torch.train.trainer import batch_schedule, split_tensors

State = Dict[str, torch.Tensor]


@dataclasses.dataclass
class EnsembleResult:
    metrics: Dict[str, float]
    true_labels: np.ndarray
    predicted_labels: np.ndarray
    class_probabilities: np.ndarray
    best_params: Optional[State]          # state_dict, on the CPU
    #: the loss of every step, in order
    losses: List[float] = dataclasses.field(default_factory=list)


def init_ensemble(configs: Sequence[ViTConfig],
                  member_params: Sequence[Mapping[str, torch.Tensor]],
                  seed: int = 42, device=None) -> TransformerEnsemble:
    """The ensemble with its backbones loaded from baseline `state_dict`s
    (`train_ensemble_cv.py:80-82`) and its meta head drawn from `seed` alone,
    so that padded and exact-shape members get the same head (flax's
    per-module init has the same property)."""
    model = TransformerEnsemble(tuple(configs), device=device)
    head = MetaHead(len(configs), configs[0].num_classes,
                    generator=torch.Generator().manual_seed(seed))
    model.classifier.load_state_dict(head.state_dict())
    for member, state in zip(model.transformers, member_params):
        member.load_state_dict(state)
    return model


def pad_members_to_templates(configs: Sequence[ViTConfig],
                             member_params: Sequence[Mapping[str, torch.Tensor]],
                             max_mlp: Optional[int] = None,
                             max_layers: Optional[int] = None):
    """Pad each member to its class-wide template with runtime depth and
    width masks (`ensemble_trainer.py:163-207`).

    Returns (template_configs, padded_state_dicts, member_masks).  Padded
    layers and FFN columns are zeros, which the masks make exact for the
    forward and the gradients, and which stay zero under Adam (zero grads).
    With dropout on, the padded FFN width draws a different dropout stream
    than the exact-shape model, as in the JAX package.
    """
    if max_mlp is None:
        max_mlp = max(parameters_config(c)[1] for c in BASELINE_CONFS)
    if max_layers is None:
        max_layers = max(parameters_config(c)[2] for c in BASELINE_CONFS)
    t_cfgs, padded, masks = [], [], []
    for cfg, state in zip(configs, member_params):
        tcfg = dataclasses.replace(cfg, mlp_dim=max(cfg.mlp_dim, max_mlp),
                                   num_layers=max(cfg.num_layers, max_layers))
        ref = next(iter(state.values()))
        padded.append({
            k: (_pad_to(state[k], shape) if k in state
                else torch.zeros(shape, dtype=ref.dtype, device=ref.device))
            for k, shape in _shapes(tcfg).items()})
        t_cfgs.append(tcfg)
        masks.append((cfg.num_layers, cfg.mlp_dim))
    return t_cfgs, padded, tuple(masks)


def crop_ensemble_params(params: Mapping[str, torch.Tensor],
                         true_configs: Sequence[ViTConfig]) -> State:
    """Crop a padded ensemble `state_dict` back to the members' true
    shapes, so checkpoints keep the exact-config layout."""
    out = {k: v for k, v in params.items() if k.startswith("classifier.")}
    for i, cfg in enumerate(true_configs):
        prefix = f"transformers.{i}."
        for k, shape in _shapes(cfg).items():
            out[prefix + k] = params[prefix + k][
                tuple(slice(0, s) for s in shape)]
    return out


def train_ensemble(
    configs: Sequence[ViTConfig],
    member_params: Sequence[Mapping[str, torch.Tensor]],
    train_split,
    val_split,
    *,
    num_epochs: int = 100,
    train_batch_size: int = 4,
    learning_rate: float = 1e-4,
    seed: int = 42,
    save_path: Optional[str] = None,
    keep_best_params: bool = True,
    tracker: Optional[BestTracker] = None,
    member_masks: Optional[Sequence[Tuple[int, int]]] = None,
    crop_to: Optional[Sequence[ViTConfig]] = None,
    device=None,
) -> EnsembleResult:
    """One ensemble, one split: the reference epoch loop, on `device` (CUDA
    unless the caller names another).

    `tracker` may be passed in to reproduce the reference's cross-fold /
    cross-combination best_choice carry-over (defect D9/D19 territory); by
    default a fresh tracker per call (the intended semantics).
    `member_masks` (from `pad_members_to_templates`) runs padded members with
    runtime masks; `crop_to` restores the true-config layout of the returned
    and saved best parameters.
    """
    device = resolve_device(device)
    model = init_ensemble(configs, member_params, seed, device=device)
    opt = adam(model.parameters(), learning_rate)

    vols, labels = split_tensors(train_split, device)
    val_vols, val_labels = split_tensors(val_split, device)
    # the whole run's batch stream; epoch reshuffles match the reference's
    # per-epoch RandomSampler
    steps = -(-len(train_split) // train_batch_size)
    idx_all, msk_all = batch_schedule(len(train_split), train_batch_size,
                                      seed, num_epochs * steps, device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def evaluate():
        probs = ensemble_eval_step(model, val_vols, member_masks)
        return metrics_vector(compute_eval_metrics(probs, val_labels)), probs

    best = device_best_init(len(METRIC_KEYS), len(val_split),
                            model.state_dict())
    losses = []
    for s in range(num_epochs * steps):
        idx, bm = idx_all[s], msk_all[s]
        probs = model(vols[idx], deterministic=False,
                      member_masks=member_masks, generator=gen)
        loss = masked_bce_on_probs(probs, labels[idx], bm)
        loss.backward()
        losses.append(loss.detach())
        opt.step()
        opt.zero_grad()
        if (s + 1) % steps == 0:
            mvec, probs = evaluate()
            best = device_consider(best, mvec, probs, model.state_dict(),
                                   False)
    mvec, probs = evaluate()
    best = device_take_if(best, mvec, probs, model.state_dict(),
                          ~best["found"])

    mvec = best["metrics"].cpu().numpy()
    cp = best["probs"].cpu().numpy()
    pl = (cp > 0.5).astype(np.int32)
    metrics = {k: float(v) for k, v in zip(METRIC_KEYS, mvec)}
    best_params = {k: v.cpu() for k, v in best["payload"].items()}
    if crop_to is not None:
        best_params = crop_ensemble_params(best_params, crop_to)
    if save_path is not None:
        save_state_dict(save_path, best_params)

    # keep the host tracker contract for callers that thread one across
    # folds/combinations (reference defect D9/D19 semantics)
    tracker = tracker if tracker is not None else BestTracker()
    tracker.consider(metrics["Specificity"], metrics["Sensitivity"],
                     metrics["AUROC"], metrics,
                     payload=(best_params, val_split.labels.copy(), pl, cp))

    return EnsembleResult(
        metrics=metrics, true_labels=val_split.labels.copy(),
        predicted_labels=pl, class_probabilities=cp,
        best_params=best_params if keep_best_params else None,
        losses=torch.stack(losses).tolist() if losses else [])
