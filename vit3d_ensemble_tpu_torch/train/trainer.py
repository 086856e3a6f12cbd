"""Single-model baseline trainer: the reference training loop, eagerly.

The counterpart of `vit3d_ensemble_tpu/train/trainer.py` (the reference's
`train()` / `valid()`, `train_baseline_cv.py:105-215`):

  * SGD(momentum 0.9, weight decay) + warmup-cosine/linear schedule;
  * per-step balanced pos_weight BCE, computed on the device;
  * eval every `eval_every` optimizer steps: sigmoid probs > 0.5, the
    11-metric suite, and the spec/sens > 0.6-then-AUROC selection rule;
  * exactly `num_steps` optimizer steps over an endless epoch stream.

The JAX trainer compiles the whole run into one program; this one is a
Python loop over steps, PyTorch's idiom.  The loop never waits for the
device: losses, metrics and the selection stay tensors until the run ends,
so the host runs ahead and enqueues.  Validation is one batched forward, and
the best parameters are kept in memory and returned.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional

import numpy as np
import torch

from vit3d_ensemble_tpu_torch.checkpoint import save_state_dict
from vit3d_ensemble_tpu_torch.configs import ViTConfig
from vit3d_ensemble_tpu_torch.data import EpochBatcher, SplitArrays
from vit3d_ensemble_tpu_torch.metrics import (
    METRIC_KEYS,
    compute_eval_metrics,
    metrics_vector,
)
from vit3d_ensemble_tpu_torch.models import VisionTransformer3D
from vit3d_ensemble_tpu_torch.models.vit3d import resolve_device
from vit3d_ensemble_tpu_torch.train.optim import sgd_momentum
from vit3d_ensemble_tpu_torch.train.schedules import make_factor
from vit3d_ensemble_tpu_torch.train.selection import (
    device_best_init,
    device_consider,
    device_take_if,
)
from vit3d_ensemble_tpu_torch.train.steps import (
    baseline_eval_step,
    masked_balanced_pos_weight,
    masked_bce_with_logits,
)

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class BaselineResult:
    metrics: Dict[str, float]            # the 11-metric dict of the best eval
    true_labels: np.ndarray
    predicted_labels: np.ndarray
    class_probabilities: np.ndarray
    best_params: Optional[Dict[str, torch.Tensor]]   # state_dict, on the CPU
    num_params_m: float
    final_loss: float
    #: the loss of every micro-batch, in order (the JAX trainer's scan
    #: outputs, of which it returns the last)
    losses: List[float] = dataclasses.field(default_factory=list)


def init_baseline(config: ViTConfig, seed: int, zero_head: bool = True,
                  device=None) -> VisionTransformer3D:
    """The model, its parameters drawn from a generator seeded with `seed`."""
    return VisionTransformer3D(config, zero_head=zero_head, vis=False,
                               device=device,
                               generator=torch.Generator().manual_seed(seed))


def batch_schedule(n: int, batch_size: int, seed: int, steps: int, device):
    """(steps, B) indices and masks of `EpochBatcher`'s stream, on `device`."""
    batcher = EpochBatcher(n, batch_size, seed=seed)
    idx = np.zeros((steps, batch_size), np.int64)
    msk = np.zeros((steps, batch_size), np.float32)
    for s, (i, m) in enumerate(batcher.batches(steps)):
        idx[s], msk[s] = i, m
    return torch.from_numpy(idx).to(device), torch.from_numpy(msk).to(device)


def split_tensors(split: SplitArrays, device):
    """(volumes, float labels) of a split, on `device`."""
    return (torch.from_numpy(split.volumes).to(device),
            torch.from_numpy(split.labels.astype(np.float32)).to(device))


def train_baseline(
    config: ViTConfig,
    train_split: SplitArrays,
    val_split: SplitArrays,
    *,
    num_steps: int = 100,
    eval_every: int = 24,
    train_batch_size: int = 4,
    learning_rate: float = 1e-4,
    weight_decay: float = 1e-2,
    warmup_steps: int = 1000,
    decay_type: str = "cosine",
    seed: int = 42,
    save_path: Optional[str] = None,
    keep_best_params: bool = True,
    balanced_weights: bool = True,
    gradient_accumulation_steps: int = 1,
    metrics_logger=None,
    device=None,
) -> BaselineResult:
    """Train one baseline config on one (train, val) split, on `device`
    (CUDA unless the caller names another).

    gradient_accumulation_steps > 1 averages gradients over k micro-batches
    per optimizer update (optax.MultiSteps in the JAX trainer) — the
    reference flag's INTENDED semantics; as shipped it trains nothing
    (defect D14, `train_baseline_cv.py:173-176`).  Dropout draws from a
    generator on `device` seeded with `seed`.
    """
    device = resolve_device(device)
    model = init_baseline(config, seed, device=device)
    params = list(model.parameters())
    opt, sched = sgd_momentum(
        params, learning_rate,
        make_factor(decay_type, warmup_steps, num_steps),
        momentum=0.9, weight_decay=weight_decay)
    accum = max(1, int(gradient_accumulation_steps))
    n_params = sum(p.numel() for p in params) / 1e6

    vols, labels = split_tensors(train_split, device)
    val_vols, val_labels = split_tensors(val_split, device)
    # eval fires every `eval_every` OPTIMIZER updates (= eval_every * accum
    # micro-steps), matching the reference's global_step gating.
    micro_per_eval = eval_every * accum
    total_micro = num_steps * accum
    idx_all, msk_all = batch_schedule(len(train_split), train_batch_size,
                                      seed, total_micro, device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def evaluate():
        probs, _ = baseline_eval_step(model, val_vols)
        return metrics_vector(compute_eval_metrics(probs, val_labels)), probs

    best = device_best_init(len(METRIC_KEYS), len(val_split),
                            model.state_dict())
    losses = []
    for s in range(total_micro):
        idx, bm = idx_all[s], msk_all[s]
        bl = labels[idx]
        out = model(vols[idx], deterministic=False, generator=gen)
        pw = masked_balanced_pos_weight(bl, bm) if balanced_weights else 1.0
        loss = masked_bce_with_logits(out.logits, bl, bm, pw)
        (loss / accum if accum > 1 else loss).backward()
        losses.append(loss.detach())
        if (s + 1) % accum == 0:
            opt.step()
            opt.zero_grad()
            sched.step()
        if (s + 1) % micro_per_eval == 0:
            mvec, probs = evaluate()
            best = device_consider(best, mvec, probs, model.state_dict(),
                                   False)
    # force-take a final eval if nothing ever accepted (the reference
    # crashes on an unbound `tl` here — defect D9 family)
    mvec, probs = evaluate()
    best = device_take_if(best, mvec, probs, model.state_dict(),
                          ~best["found"])

    losses = torch.stack(losses).tolist() if losses else []
    final_loss = losses[-1] if losses else 0.0
    mvec = best["metrics"].cpu().numpy()
    cp = best["probs"].cpu().numpy()
    pl = (cp > 0.5).astype(np.int32)
    metrics = {k: float(v) for k, v in zip(METRIC_KEYS, mvec)}
    best_params = {k: v.cpu() for k, v in best["payload"].items()}
    if save_path is not None:
        save_state_dict(save_path, best_params)
        logger.info("saved checkpoint to %s", save_path)
    if metrics_logger is not None:
        metrics_logger.log("best_eval", loss=final_loss, **metrics)
    logger.info("best AUROC: %s", metrics["AUROC"])

    return BaselineResult(
        metrics=metrics,
        true_labels=val_split.labels.copy(),
        predicted_labels=pl,
        class_probabilities=cp,
        best_params=best_params if keep_best_params else None,
        num_params_m=n_params,
        final_loss=final_loss,
        losses=losses,
    )
