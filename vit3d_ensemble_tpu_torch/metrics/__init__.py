"""The 11-metric evaluation suite: on the device (the trainers' selection)
and on the host, in numpy (the drivers' confidence metrics and Brier
scores)."""

from vit3d_ensemble_tpu_torch.metrics.torch_metrics import (  # noqa: F401
    METRIC_KEYS,
    EvalMetrics,
    compute_eval_metrics,
    metrics_vector,
)
from vit3d_ensemble_tpu_torch.metrics.host import (  # noqa: F401
    brier_score_one_class,
    calculate_confidence_metrics,
    eleven_metrics,
)
