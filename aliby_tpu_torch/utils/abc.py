"""Shared parameter / process base classes.

Counterpart of ``aliby_tpu/utils/abc.py`` (the shared kernel,
``agora/abc.py:16-178``):
``ParametersABC`` turns keyword arguments into attributes and round-trips
through nested dicts and YAML; ``default()`` merges class-level ``_defaults``
with overrides; ``update()`` finds a key anywhere in the nested tree.
``StepABC.run_tp`` wraps ``_run_tp`` with wall-clock timing.

yaml is imported inside the two methods that read or write it: the GPU
hosts of the port need not have it.
"""

from __future__ import annotations

import logging
from copy import deepcopy
from pathlib import Path
from typing import Any


def _to_plain(value: Any) -> Any:
    """Recursively convert ParametersABC instances / containers to plain data."""
    if isinstance(value, ParametersABC):
        return {k: _to_plain(v) for k, v in value.__dict__.items()}
    if isinstance(value, dict):
        return {k: _to_plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_plain(v) for v in value)
    return value


def _find_and_set(tree: dict, key: str, value: Any) -> bool:
    """Depth-first search for ``key`` in a nested dict; set first match."""
    if key in tree:
        tree[key] = value
        return True
    for v in tree.values():
        if isinstance(v, dict) and _find_and_set(v, key, value):
            return True
    return False


class ParametersABC:
    """Keyword-arguments-as-attributes parameter bag with dict/YAML IO."""

    def __init__(self, **kwargs):
        for name, value in kwargs.items():
            if isinstance(value, dict):
                # Nested dicts stay dicts (round-trip fidelity).
                setattr(self, name, value)
            else:
                setattr(self, name, value)

    # -- serialization ----------------------------------------------------
    def to_dict(self) -> dict:
        return _to_plain(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ParametersABC":
        return cls(**d)

    def to_yaml(self, path: str | Path | None = None) -> str:
        import yaml

        text = yaml.dump(self.to_dict(), default_flow_style=False)
        if path is not None:
            Path(path).write_text(text)
        return text

    @classmethod
    def from_yaml(cls, source: str | Path) -> "ParametersABC":
        import yaml

        as_path = Path(source) if not str(source).lstrip().startswith(("{", "\n")) else None
        if as_path is not None and as_path.exists():
            text = as_path.read_text()
        else:
            text = str(source)
        return cls(**yaml.safe_load(text))

    # -- defaults ---------------------------------------------------------
    _defaults: dict = {}

    @classmethod
    def default(cls, **overrides) -> "ParametersABC":
        merged = deepcopy(cls._defaults)
        merged.update(overrides)
        return cls(**merged)

    def update(self, key: str, value: Any) -> None:
        """Set ``key`` to ``value`` wherever it appears in the parameter tree."""
        if hasattr(self, key) and not isinstance(getattr(self, key), dict):
            setattr(self, key, value)
            return
        tree = self.__dict__
        if not _find_and_set(tree, key, value):
            # Search inside nested dict attributes.
            for attr, v in tree.items():
                if isinstance(v, dict) and _find_and_set(v, key, value):
                    return
            raise KeyError(f"Parameter '{key}' not found in {type(self).__name__}")

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.to_dict()!r})"

    def __eq__(self, other) -> bool:
        return isinstance(other, ParametersABC) and self.to_dict() == other.to_dict()


class ProcessABC:
    """A runnable step configured by a ParametersABC instance.

    Parameters become attributes of the process (reference behavior,
    ``agora/abc.py:129-158``).
    """

    def __init__(self, parameters: ParametersABC | None = None):
        self.parameters = parameters
        if parameters is not None:
            for name, value in parameters.to_dict().items():
                setattr(self, name, value)

    @property
    def logger(self) -> logging.Logger:
        return logging.getLogger("aliby_tpu_torch")

    def log(self, message: str, level: str = "warning") -> None:
        getattr(self.logger, level)(message)

    def run(self, *args, **kwargs):
        raise NotImplementedError


class StepABC(ProcessABC):
    """A per-timepoint step; ``run_tp`` times and delegates to ``_run_tp``."""

    def _run_tp(self, tp: int, *args, **kwargs):
        raise NotImplementedError

    def run_tp(self, tp: int, *args, **kwargs):
        from aliby_tpu_torch.utils.timer import timer

        return timer(self._run_tp)(tp, *args, **kwargs)
