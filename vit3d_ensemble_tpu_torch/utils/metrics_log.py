"""Structured metrics logging: a JSON-lines event stream per run.

A copy of `MetricsLogger` (`vit3d_ensemble_tpu/utils/metrics_log.py`), which
the trainers take as their `metrics_logger`: one JSON object per line,
appended to the file it is given.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)

    def log(self, event: str, **fields: Any) -> None:
        if not self.path:
            return
        record: Dict[str, Any] = {"ts": time.time(), "event": event}
        record.update(fields)
        with open(self.path, "a") as f:
            f.write(json.dumps(record, default=float) + "\n")
