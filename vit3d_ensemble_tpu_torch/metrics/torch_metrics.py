"""Evaluation metrics on the device, masked and branch-free.

The counterpart of `vit3d_ensemble_tpu/metrics/jax_metrics.py`: the same
O(N^2) pairwise forms, which match sklearn exactly (ties included) for the
small evaluation sets in play, so the trainers keep the metrics and the
selection on the device and never wait for the host during a run.

Masks support padded evaluation batches: masked-out entries contribute to
nothing.  Metric definitions (sklearn equivalences):
  specificity  = recall(pos_label=0)
  sensitivity  = recall(pos_label=1)
  balanced_acc = (spec + sens) / 2
  auroc        = Mann-Whitney U with midranks (== trapezoid ROC with ties)
  auprc        = average_precision_score (step-function AP, tie-grouped)
  f2           = fbeta_score(beta=2)
  brier        = mean((y - p)^2); bsnc/bspc are the per-class restrictions
                 (`tools.py:125-133`)
  csp/cse      = confident-specificity/-sensitivity buckets
                 (`tools.py:100-121`)

`METRIC_KEYS` and `metrics_vector` are `sweep/engine.py:54-62`'s, which the
JAX trainers import from there.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

#: The 11 metrics in the order of the selection vector (spec at 0, sens at
#: 1, AUROC at 3).
METRIC_KEYS = ("Specificity", "Sensitivity", "Accuracy", "AUROC", "AUPRC",
               "F2-score", "CSP", "CSE", "BSNC", "BSPC", "BS")


class EvalMetrics(NamedTuple):
    specificity: torch.Tensor
    sensitivity: torch.Tensor
    balanced_accuracy: torch.Tensor
    auroc: torch.Tensor
    auprc: torch.Tensor
    f2: torch.Tensor
    brier: torch.Tensor
    bsnc: torch.Tensor
    bspc: torch.Tensor
    csp: torch.Tensor
    cse: torch.Tensor


def metrics_vector(m: EvalMetrics) -> torch.Tensor:
    """The 11 metrics stacked in `METRIC_KEYS` order."""
    return torch.stack([
        m.specificity, m.sensitivity, m.balanced_accuracy, m.auroc, m.auprc,
        m.f2, m.csp, m.cse, m.bsnc, m.bspc, m.brier,
    ])


def _safe_div(a, b):
    return torch.where(b > 0, a / torch.where(b > 0, b, torch.ones_like(b)),
                       torch.zeros_like(a))


def _mask(scores, mask):
    return torch.ones_like(scores) if mask is None else mask.to(scores.dtype)


def auroc(scores: torch.Tensor, labels: torch.Tensor,
          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Tie-aware AUROC via pairwise midranks (== sklearn roc_auc_score)."""
    m = _mask(scores, mask)
    labels = labels.to(scores.dtype)
    s_i = scores[:, None]
    s_j = scores[None, :]
    mm = m[:, None] * m[None, :]
    less = torch.sum((s_j < s_i) * mm, dim=1)
    equal = torch.sum((s_j == s_i) * mm, dim=1)      # includes self
    midrank = less + (equal + 1.0) / 2.0             # 1-indexed midrank
    n_pos = torch.sum(labels * m)
    n_neg = torch.sum((1.0 - labels) * m)
    rank_sum_pos = torch.sum(midrank * labels * m)
    u = rank_sum_pos - n_pos * (n_pos + 1.0) / 2.0
    return _safe_div(u, n_pos * n_neg)


def average_precision(scores: torch.Tensor, labels: torch.Tensor,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sklearn average_precision_score with tie grouping, via pairwise >=."""
    m = _mask(scores, mask)
    labels = labels.to(scores.dtype)
    n_pos = torch.sum(labels * m)
    # For each sample i (as threshold): TP_i = sum_j [s_j >= s_i] y_j m_j
    ge = (scores[None, :] >= scores[:, None]).to(scores.dtype) * m[None, :]
    tp = ge @ (labels * m)
    fp = ge @ ((1.0 - labels) * m)
    prec = _safe_div(tp, tp + fp)
    rec = _safe_div(tp, n_pos)
    # Sort thresholds descending; ties produce zero recall increments for
    # all but the group head, so duplicates contribute nothing (== sklearn).
    keyed = torch.where(m > 0, scores, torch.full_like(scores, -torch.inf))
    order = torch.argsort(-keyed, stable=True)
    rec_s = rec[order] * m[order]
    prec_s = prec[order] * m[order]
    prev = torch.cat([rec_s.new_zeros(1), rec_s[:-1]])
    return torch.sum((rec_s - prev) * prec_s)


def compute_eval_metrics(probs: torch.Tensor, labels: torch.Tensor,
                         mask: Optional[torch.Tensor] = None,
                         threshold: float = 0.5) -> EvalMetrics:
    """The full 11-metric suite from sigmoid probabilities.

    Predictions use p > 0.5 like the reference (`tools.py:51`,
    `train_baseline_cv.py:82`).
    """
    m = _mask(probs, mask)
    y = labels.to(probs.dtype)
    pred = (probs > threshold).to(probs.dtype)

    tp = torch.sum(pred * y * m)
    tn = torch.sum((1 - pred) * (1 - y) * m)
    fp = torch.sum(pred * (1 - y) * m)
    fn = torch.sum((1 - pred) * y * m)

    spec = _safe_div(tn, tn + fp)
    sens = _safe_div(tp, tp + fn)
    bacc = 0.5 * (spec + sens)
    prec = _safe_div(tp, tp + fp)
    f2 = _safe_div(5.0 * prec * sens, 4.0 * prec + sens)

    roc = auroc(probs, labels, m)
    ap = average_precision(probs, labels, m)

    sq = (y - probs) ** 2
    brier = _safe_div(torch.sum(sq * m), torch.sum(m))
    bsnc = _safe_div(torch.sum(sq * (1 - y) * m), torch.sum((1 - y) * m))
    bspc = _safe_div(torch.sum(sq * y * m), torch.sum(y * m))

    # confidence metrics (`tools.py:100-121`)
    tn_conf = torch.sum((1 - pred) * (1 - y) * (probs < 0.3) * m)
    tp_conf = torch.sum(pred * y * (probs > 0.7) * m)
    csp = _safe_div(tn_conf, tn + fp)
    cse = _safe_div(tp_conf, tp + fn)

    return EvalMetrics(
        specificity=spec, sensitivity=sens, balanced_accuracy=bacc,
        auroc=roc, auprc=ap, f2=f2, brier=brier, bsnc=bsnc, bspc=bspc,
        csp=csp, cse=cse,
    )
