"""Profiling hooks on ``torch.profiler`` (counterpart of
``aliby_tpu/utils/profiling.py``) and the port's one span.

:func:`span` names a region of the program where its work is queued
(``<layer>.<what>``: ``runner.dispatch``, ``seg.network``, ...). It costs a
few hundred nanoseconds and does nothing else unless

- a ``torch.profiler`` is recording: the span is then a ``record_function``
  range, in the trace on the clock of the device's activity;
- the process's recorder is on (:func:`recording`): the span then adds to
  in-memory totals for its name: calls, host seconds and host self-seconds
  (less the spans nested in it on its thread), and, for work queued on a
  CUDA device, its stream time: the time between two timing events
  recorded on the device's current stream at its start and its end.

:func:`totals` reads the totals (the events are resolved there, so the
recorder adds no synchronise), :func:`reset` clears them. For a Chrome
trace of a region wrap it in :func:`trace`.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time
from pathlib import Path

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import ProfilerActivity, profile, record_function

_RESOLVE_AT = 4096  # pending event pairs past which finished ones are resolved

_lock = threading.Lock()
_recorders = 0  # open recording() blocks
_totals: dict[str, list] = {}  # name -> [calls, host_s, self_s, device_s or None]
_pending: list = []  # (name, start event, end event) not yet resolved
_local = threading.local()  # .open: this thread's recorded spans; .host: its host_s by name
_OFF = contextlib.nullcontext()


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


def span(name: str, device=False):
    """A named region (a context manager). ``device`` is the device the
    region's work is queued on; on a CUDA device the recorder also takes
    the region's stream time."""
    if _recorders:
        return _Span(name, device)
    if _autograd_profiler._is_profiler_enabled:  # True under every torch.profiler
        return record_function(name)
    return _OFF


@contextlib.contextmanager
def recording():
    """The recorder on for the block (process-wide: every thread's spans
    are recorded while any block is open)."""
    global _recorders
    with _lock:
        _recorders += 1
    try:
        yield
    finally:
        with _lock:
            _recorders -= 1


def totals() -> dict[str, dict]:
    """``{name: {"n", "host_s", "self_s", "device_s"}}`` of every span
    recorded since :func:`reset`; ``device_s`` is None for a span that took
    no stream time. Waits for the recorded events: read after the work."""
    _resolve(wait=True)
    with _lock:
        return {name: {"n": n, "host_s": host, "self_s": own, "device_s": dev}
                for name, (n, host, own, dev) in _totals.items()}


def reset() -> None:
    with _lock:
        _totals.clear()
        _pending.clear()


def thread_host_s() -> dict[str, float]:
    """This thread's recorded host seconds by span name (a copy)."""
    return dict(getattr(_local, "host", {}))


def _resolve(wait: bool) -> None:
    with _lock:
        pending = list(_pending)
        _pending.clear()
    keep, done = [], []
    for name, start, end in pending:
        if wait:
            end.synchronize()
        elif not end.query():
            keep.append((name, start, end))
            continue
        done.append((name, start.elapsed_time(end) / 1e3))
    with _lock:
        _pending[:0] = keep
        for name, seconds in done:
            entry = _totals.setdefault(name, [0, 0.0, 0.0, None])
            entry[3] = (entry[3] or 0.0) + seconds


class _Span:
    """A span while the recorder is on."""

    __slots__ = ("name", "stream", "start", "range", "t0", "inner")

    def __init__(self, name: str, device):
        self.name = name
        self.stream = None
        if device and torch.device(device).type == "cuda":
            self.stream = torch.cuda.current_stream(device)

    def __enter__(self):
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            self.range = record_function(self.name)
            self.range.__enter__()
        if self.stream is not None:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        try:
            stack = _local.open
        except AttributeError:
            stack = _local.open = []
            _local.host = {}
        stack.append(self)
        self.inner = 0.0
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host = time.perf_counter() - self.t0
        stack = _local.open
        stack.pop()
        if stack:
            stack[-1].inner += host
        _local.host[self.name] = _local.host.get(self.name, 0.0) + host
        if self.stream is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
        with _lock:
            entry = _totals.setdefault(self.name, [0, 0.0, 0.0, None])
            entry[0] += 1
            entry[1] += host
            entry[2] += host - self.inner
            if self.stream is not None:
                _pending.append((self.name, self.start, end))
            many = len(_pending) >= _RESOLVE_AT
        if many:
            _resolve(wait=False)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False
