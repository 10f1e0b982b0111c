"""Wall-clock step timing (reference: ``agora/logging_timer.py:5-16``)."""

from __future__ import annotations

import functools
import logging
import time

_logger = logging.getLogger("aliby_tpu_torch")


def timer(fn):
    """Log ``<qualname> took X.XXXXs`` at DEBUG around every call."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        _logger.debug("%s took %.4fs", getattr(fn, "__qualname__", fn), time.perf_counter() - t0)
        return result

    return wrapped


class StepTimer:
    """Accumulates per-step wall-clock for observability (bench + profiles)."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def add(self, name: str, seconds: float) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            k: {"total_s": self.totals[k], "calls": self.counts[k]}
            for k in sorted(self.totals)
        }
