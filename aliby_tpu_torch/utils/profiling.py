"""Profiling hooks on ``torch.profiler`` (counterpart of
``aliby_tpu/utils/profiling.py``).

Every engine run accumulates per-step wall-clock in ``state["timer"]``; for
device-level analysis wrap a region in :func:`trace` and open the Chrome
trace it writes (``chrome://tracing`` or Perfetto), and name sub-regions
with :func:`annotate`.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(log_dir: str | Path | None = None):
    """Profile the enclosed region's CPU and (where there is a card) CUDA
    activity; on exit write the Chrome trace ``<log_dir>/trace.json``.
    Yields the ``torch.profiler.profile`` (``key_averages()``, ``events()``).
    ``log_dir`` defaults to ``aliby_tpu_torch_trace`` under the temporary
    directory."""
    log_dir = Path(log_dir or os.path.join(tempfile.gettempdir(), "aliby_tpu_torch_trace"))
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named sub-region of a trace: a ``record_function`` range, and an
    NVTX range on the card."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
