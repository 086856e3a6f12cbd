"""Best-checkpoint selection rule.

The reference's decision process (`train_baseline_cv.py:192-204`, the same
rule in every trainer): prefer evaluations with BOTH specificity > 0.6 and
sensitivity > 0.6 — once one is seen, only higher-AUROC evaluations that
also satisfy the constraint can replace it; before any constrained
evaluation is seen, track the max-AUROC one.

`BestTracker` is a copy of the JAX package's host form
(`vit3d_ensemble_tpu/train/selection.py`).  The `device_*` functions are the
same rule on tensors, branch-free, so a trainer selects on the device
without waiting for the host; the payload is a dict of tensors (a
`state_dict`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import torch


@dataclasses.dataclass
class BestTracker:
    best_choice: bool = False
    best_auc: float = 0.0
    best_metrics: Optional[Dict[str, float]] = None
    payload: Any = None          # e.g. best params / (tl, pl, cp)

    def consider(self, specificity: float, sensitivity: float,
                 roc_auc: float, metrics: Dict[str, float],
                 payload: Any = None) -> bool:
        """Returns True when this evaluation becomes the new best
        (== the reference's save-checkpoint event)."""
        if specificity > 0.6 and sensitivity > 0.6:
            accept = (not self.best_choice) or roc_auc > self.best_auc
            if accept:
                self._take(roc_auc, metrics, payload)
            self.best_choice = True
            return accept
        if (not self.best_choice) and roc_auc > self.best_auc:
            self._take(roc_auc, metrics, payload)
            return True
        return False

    def _take(self, roc_auc, metrics, payload):
        self.best_auc = roc_auc
        self.best_metrics = dict(metrics)
        self.payload = payload


# --- on-device form -----------------------------------------------------------


def device_best_init(metrics_dim: int, probs_dim: int,
                     payload: Mapping[str, torch.Tensor]) -> dict:
    """The initial best state; the payload is copied."""
    ref = next(iter(payload.values()))
    zero = torch.zeros((), device=ref.device)
    false = torch.zeros((), dtype=torch.bool, device=ref.device)
    return dict(auc=zero, choice=false, found=false,
                metrics=torch.zeros(metrics_dim, device=ref.device),
                probs=torch.zeros(probs_dim, device=ref.device),
                payload={k: v.detach().clone() for k, v in payload.items()})


def device_consider(best: dict, mvec: torch.Tensor, probs: torch.Tensor,
                    payload: Mapping[str, torch.Tensor], force) -> dict:
    """The rule of `BestTracker.consider`, as a branch-free update.

    mvec is the 11-metric vector in `METRIC_KEYS` order (spec at 0, sens at
    1, AUROC at 3).  `force` accepts unconditionally.
    """
    spec, sens, auc = mvec[0], mvec[1], mvec[3]
    constrained = (spec > 0.6) & (sens > 0.6)
    accept = torch.where(constrained, ~best["choice"] | (auc > best["auc"]),
                         ~best["choice"] & (auc > best["auc"]))
    accept = accept | force
    return _apply_accept(best, mvec, probs, payload, accept,
                         choice=best["choice"] | constrained)


def device_take_if(best: dict, mvec: torch.Tensor, probs: torch.Tensor,
                   payload: Mapping[str, torch.Tensor], cond) -> dict:
    """Accept iff `cond`, bypassing the rule: the end-of-run eval fills in
    results only when no earlier eval accepted (`trainer.py:188-192`)."""
    return _apply_accept(best, mvec, probs, payload, cond,
                         choice=best["choice"])


def _apply_accept(best, mvec, probs, payload, accept, choice) -> dict:
    return dict(
        auc=torch.where(accept, mvec[3], best["auc"]),
        choice=choice,
        found=best["found"] | accept,
        metrics=torch.where(accept, mvec, best["metrics"]),
        probs=torch.where(accept, probs, best["probs"]),
        payload={k: torch.where(accept, v.detach(), best["payload"][k])
                 for k, v in payload.items()},
    )
