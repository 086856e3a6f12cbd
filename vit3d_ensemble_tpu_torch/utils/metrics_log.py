"""Structured metrics logging: a JSON-lines event stream per run.

A copy of `MetricsLogger` and `default_logger`
(`vit3d_ensemble_tpu/utils/metrics_log.py`); the trainers take a logger as
their `metrics_logger`: one JSON object per line, appended to the file it is
given.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

from vit3d_ensemble_tpu_torch.parallel.mesh import is_writer


class MetricsLogger:
    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)

    def log(self, event: str, **fields: Any) -> None:
        """Append one event (in a process group, rank 0 alone)."""
        if not self.path or not is_writer():
            return
        record: Dict[str, Any] = {"ts": time.time(), "event": event}
        record.update(fields)
        with open(self.path, "a") as f:
            f.write(json.dumps(record, default=float) + "\n")


def default_logger(output_dir: Optional[str]) -> MetricsLogger:
    """`<output_dir>/metrics.jsonl`, or a logger that writes nothing."""
    return MetricsLogger(
        os.path.join(output_dir, "metrics.jsonl") if output_dir else None)
