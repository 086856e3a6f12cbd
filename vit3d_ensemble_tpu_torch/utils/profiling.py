"""Tracing hook of the drivers, the counterpart of
`vit3d_ensemble_tpu/utils/profiling.py` on `torch.profiler`.

`profile_to(dir)` is a context manager around any driver section; it writes
a Chrome trace (`chrome://tracing`, ui.perfetto.dev) of the host's ops and,
on a card, its kernels into `dir`.  The sweep driver exposes it as
`profile_dir`.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def profile_to(trace_dir: Optional[str]) -> Iterator[None]:
    """Capture a trace into trace_dir (no-op when None)."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        trace_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
