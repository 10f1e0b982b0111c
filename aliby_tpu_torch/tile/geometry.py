"""Tile geometry: positions, drifts, crop ranges (counterpart of
``aliby_tpu/tile/geometry.py``).

Reference semantics (``tile/tiles.py:8-166``): a ``Tile`` is an initial
centre plus a shared per-timepoint drift history; its centre at time t is
``centre - sum(drifts[:t+1])``; ``as_range`` yields the (y, x) slices of the
half-size crop around that centre.
"""

from __future__ import annotations

import numpy as np


class TileLocations:
    """All tiles of one position + the cumulative drift track."""

    def __init__(
        self,
        initial_centres: np.ndarray,
        tile_size: tuple[int, int] | None,
        max_size: int = 1200,
        drifts: list | None = None,
    ):
        self.initial_centres = np.asarray(initial_centres, dtype=float).reshape(-1, 2)
        self.tile_size = tile_size
        self.max_size = max_size
        self.drifts = [np.asarray(d, dtype=float) for d in (drifts or [])]

    @classmethod
    def from_tiler_init(
        cls, centres, tile_size: int | tuple[int, int] | None, max_size: int = 1200
    ) -> "TileLocations":
        if isinstance(tile_size, int):
            tile_size = (tile_size, tile_size)
        return cls(centres, tile_size, max_size=max_size, drifts=[np.zeros(2)])

    def __len__(self) -> int:
        return len(self.initial_centres)

    @property
    def shape(self):
        return len(self), len(self.drifts)

    def add_drift(self, drift) -> None:
        self.drifts.append(np.asarray(drift, dtype=float))

    def total_drift(self, tp: int) -> np.ndarray:
        if not self.drifts:
            return np.zeros(2)
        return np.sum(self.drifts[: tp + 1], axis=0)

    def centres_at_time(self, tp: int) -> np.ndarray:
        return self.initial_centres - self.total_drift(tp)[None, :]

    def as_range(self, tile_index: int, tp: int) -> tuple[slice, slice]:
        cy, cx = self.centres_at_time(tp)[tile_index]
        th, tw = self.tile_size
        y0 = int(round(cy - th / 2))
        x0 = int(round(cx - tw / 2))
        return slice(y0, y0 + th), slice(x0, x0 + tw)

    def to_dict(self, tp: int) -> dict:
        """Serializable record: init data at tp 0, drift each tp."""
        out = {"drift": np.asarray(self.drifts[-1] if self.drifts else np.zeros(2))}
        if tp == 0:
            out.update(
                {
                    "trap_locations": self.initial_centres.copy(),
                    "attrs/tile_size": np.asarray(self.tile_size or (0, 0)),
                    "attrs/max_size": np.asarray(self.max_size),
                }
            )
        return out
