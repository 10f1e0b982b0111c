"""Device selection: CUDA by default, the CPU only when the caller asks."""

from __future__ import annotations

import threading
from contextlib import contextmanager

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``; anything else as given. Raises when CUDA is
    asked for and absent: nothing falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class HeldFlags:
    """Process-wide backend flags (``torch.backends.cudnn``'s) held at the
    given values while any thread is inside ``with flags():``. The flags are
    the process's, not a thread's: the first thread in saves the values it
    finds and sets the held ones, the last one out restores the saved ones,
    under a lock. (A save-and-restore per call races: one thread's exit
    restores the flags under another thread's work.)"""

    def __init__(self, namespace, **values):
        self.namespace = namespace
        self.values = values
        self._lock = threading.Lock()
        self._users = 0
        self._saved: dict = {}

    @contextmanager
    def __call__(self):
        with self._lock:
            if self._users == 0:
                self._saved = {k: getattr(self.namespace, k) for k in self.values}
                for k, v in self.values.items():
                    setattr(self.namespace, k, v)
            self._users += 1
        try:
            yield
        finally:
            with self._lock:
                self._users -= 1
                if self._users == 0:
                    for k, v in self._saved.items():
                        setattr(self.namespace, k, v)
