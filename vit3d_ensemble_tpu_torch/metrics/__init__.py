"""Evaluation metrics on the device (the 11-metric suite of the trainers)."""

from vit3d_ensemble_tpu_torch.metrics.torch_metrics import (  # noqa: F401
    METRIC_KEYS,
    EvalMetrics,
    compute_eval_metrics,
    metrics_vector,
)
