"""Host-side metrics for reporting, in numpy alone.

The counterpart of `vit3d_ensemble_tpu/metrics/host.py`: the confidence
metrics and per-class Brier scores of `tools.py:100-133`, and the per-fold
metric dict (`train_baseline_cv.py:286-297`).  The JAX package takes the
scores from sklearn, which the card's host lacks; they are written out
here with sklearn's (1.9) definitions, binary labels {0, 1}:

  * recall of either class, 0 where the class is absent (zero_division);
  * balanced accuracy: the mean recall over the classes present in y;
  * ROC AUC by the rank-sum statistic, tied scores taking their average
    rank; NaN where y holds one class;
  * average precision in sklearn's step form, sum (R_k - R_{k-1}) P_k over
    the distinct thresholds; with no positive, the recall is 1 everywhere
    and the sum 0;
  * F2 = 5 tp / (5 tp + 4 fn + fp), 0 where that denominator is 0;
  * the Brier score, mean (y - p)^2.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def calculate_confidence_metrics(true_labels: Sequence[int],
                                 predicted_labels: Sequence[int],
                                 class_probabilities: Sequence[float]):
    """CSP / CSE confidence buckets (`tools.py:100-121`)."""
    y = np.asarray(true_labels)
    pred = np.asarray(predicted_labels)
    p = np.asarray(class_probabilities)
    tn = (y == 0) & (pred == 0)
    tp = (y == 1) & (pred == 1)
    fp = (y == 0) & (pred == 1)
    fn = (y == 1) & (pred == 0)
    denom_n = tn.sum() + fp.sum()
    denom_p = tp.sum() + fn.sum()
    csp = (tn & (p < 0.3)).sum() / denom_n if denom_n > 0 else 0
    cse = (tp & (p > 0.7)).sum() / denom_p if denom_p > 0 else 0
    return float(csp), float(cse)


def brier_score_one_class(y_true, y_prob, cl: int = 0) -> float:
    """Per-class Brier restriction (`tools.py:125-133`)."""
    y = np.asarray(y_true, dtype=float)
    p = np.asarray(y_prob, dtype=float)
    m = y == cl
    return float(np.average((y[m] - p[m]) ** 2))


def _recall(y: np.ndarray, pred: np.ndarray, cls: int) -> float:
    n = int((y == cls).sum())
    return float(((y == cls) & (pred == cls)).sum() / n) if n else 0.0


def _balanced_accuracy(y: np.ndarray, pred: np.ndarray) -> float:
    return float(np.mean([_recall(y, pred, c) for c in np.unique(y)]))


def _roc_auc(y: np.ndarray, p: np.ndarray) -> float:
    pos = y == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(p, kind="mergesort")
    sorted_p = p[order]
    ranks = np.empty(len(p), np.float64)
    # 1-based ranks, each run of tied scores given the mean of its ranks
    starts = np.flatnonzero(np.r_[True, sorted_p[1:] != sorted_p[:-1]])
    ends = np.r_[starts[1:], len(p)]
    for s, e in zip(starts, ends):
        ranks[order[s:e]] = (s + 1 + e) / 2.0
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0)
                 / (n_pos * n_neg))


def _average_precision(y: np.ndarray, p: np.ndarray) -> float:
    order = np.argsort(p, kind="mergesort")[::-1]
    sorted_p, sorted_y = p[order], y[order].astype(np.float64)
    last = np.r_[np.flatnonzero(np.diff(sorted_p)), len(p) - 1]
    tps = np.cumsum(sorted_y)[last]
    fps = 1 + last - tps
    precision = tps / (tps + fps)
    recall = tps / tps[-1] if tps[-1] > 0 else np.ones_like(tps)
    precision = np.r_[precision[::-1], 1.0]
    recall = np.r_[recall[::-1], 0.0]
    return float(-np.sum(np.diff(recall) * precision[:-1]))


def _f2(y: np.ndarray, pred: np.ndarray) -> float:
    tp = int(((y == 1) & (pred == 1)).sum())
    fn = int(((y == 1) & (pred == 0)).sum())
    fp = int(((y == 0) & (pred == 1)).sum())
    denom = 5 * tp + 4 * fn + fp
    return 5 * tp / denom if denom else 0.0


def eleven_metrics(true_labels, predicted_labels,
                   class_probabilities) -> Dict[str, float]:
    """The full per-fold metric dict (`train_baseline_cv.py:286-297`)."""
    y, pred, p = (np.asarray(true_labels), np.asarray(predicted_labels),
                  np.asarray(class_probabilities, dtype=np.float64))
    csp, cse = calculate_confidence_metrics(y, pred, p)
    return {
        "Specificity": _recall(y, pred, 0),
        "Sensitivity": _recall(y, pred, 1),
        "Accuracy": _balanced_accuracy(y, pred),
        "AUROC": _roc_auc(y, p),
        "AUPRC": _average_precision(y, p),
        "F2-score": float(_f2(y, pred)),
        "CSP": csp,
        "CSE": cse,
        "BSNC": brier_score_one_class(y, p, cl=0),
        "BSPC": brier_score_one_class(y, p, cl=1),
        "BS": float(np.mean((y.astype(np.float64) - p) ** 2)),
    }
