"""Small IO utilities (counterpart of ``aliby_tpu/io/utils.py``;
reference ``agora/io/utils.py:21-102``)."""

from __future__ import annotations

import functools
import logging
import time
from collections import OrderedDict
from pathlib import Path
from typing import Callable

logger = logging.getLogger("aliby_tpu_torch")


class Cache:
    """FIFO-bounded memo for a loader function (image reads)."""

    def __init__(self, load_fn: Callable | None = None, max_items: int = 20):
        if load_fn is None:
            from aliby_tpu_torch.io.image import _read_image_file as load_fn
        self.load_fn = load_fn
        self.max_items = max_items
        self._store: OrderedDict = OrderedDict()

    def __call__(self, key):
        if key not in self._store:
            self._store[key] = self.load_fn(key)
            while len(self._store) > self.max_items:
                self._store.popitem(last=False)
        return self._store[key]

    def clear(self) -> None:
        self._store.clear()


def get_store_path(save_dir: str | Path, store: str, name: str) -> Path:
    """Canonical per-position artifact path under a save directory."""
    return Path(save_dir) / f"{name}{store}"


def timed(description: str | None = None):
    """Parametrized timing decorator logging at DEBUG."""

    def decorator(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            result = fn(*args, **kwargs)
            logger.debug(
                "%s took %.4fs",
                description or getattr(fn, "__qualname__", fn),
                time.perf_counter() - t0,
            )
            return result

        return wrapped

    return decorator
