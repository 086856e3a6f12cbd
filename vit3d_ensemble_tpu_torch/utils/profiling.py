"""Tracing hook of the drivers, the counterpart of
`vit3d_ensemble_tpu/utils/profiling.py` on `torch.profiler`.

`profile_to(dir)` is a context manager around any driver section; it writes
a Chrome trace (`chrome://tracing`, ui.perfetto.dev) of the host's ops and,
on a card, its kernels into `dir`.  The sweep driver exposes it as
`profile_dir`.  `step_annotation(name, step)` names a step's span in such a
trace, as `jax.profiler.StepTraceAnnotation` does.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def profile_to(trace_dir: Optional[str]) -> Iterator[None]:
    """Capture a trace into trace_dir (no-op when None, and in a process
    group on every rank but 0)."""
    from vit3d_ensemble_tpu_torch.parallel.mesh import is_writer

    if not trace_dir or not is_writer():
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


def step_annotation(name: str, step: int):
    """A `torch.profiler.record_function` context whose span is named
    `name` and the step, `"{name}#{step}"`: the counterpart of
    `jax.profiler.StepTraceAnnotation(name, step_num=step)`.  Outside a
    profiled region it records nothing."""
    from torch.profiler import record_function

    return record_function(f"{name}#{int(step)}")
