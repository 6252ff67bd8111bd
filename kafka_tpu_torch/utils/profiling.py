"""Profiling hooks (port of ``kafka_tpu/utils/profiling.py``).

- :func:`trace` — a ``torch.profiler`` capture (CPU activity, and CUDA
  activity with a card) of the enclosed work, written as a capture
  session under ``logdir`` in the layout ``telemetry.devprof`` parses
  (Perfetto-viewable once unzipped); a no-op without a logdir.
- :func:`annotate` — a named ``record_function`` span, so engine phases
  show up labelled inside a capture.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """Capture a profiler trace of the enclosed work into ``logdir``
    (no-op if ``None``)."""
    if not logdir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..telemetry import devprof

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    epoch = time.time()
    with profile(activities=activities) as prof:
        yield
    devprof.export_profile(prof, logdir, epoch)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Label the enclosed host work as a named span in profiler traces."""
    from torch.profiler import record_function

    with record_function(name):
        yield
