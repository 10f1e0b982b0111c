"""Legacy HDF5 compatibility: append-capable writers + state snapshots
(counterpart of ``aliby_tpu/io/h5compat.py``; h5py is imported where a
file is opened).

The reference's h5 era (``agora/io/writer.py:42-396``, ``dynamic_writer``,
``reader.py``) wrote tiler geometry, per-cell outlines and tracker state to
HDF5 with skip-already-written-timepoint guards, and could rehydrate
tracker state for resume. Parquet/npz is this framework's live format; this
module keeps a compact h5 bridge so downstream h5-era tooling can consume
outputs and positions can resume mid-movie:

- ``DynamicWriter``: append-or-skip datasets keyed by timepoint;
- ``TilerH5Writer``: trap locations + per-tp drifts;
- ``StateH5Writer`` / ``read_state``: tracker-state snapshot and reload.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


class DynamicWriter:
    """Grow datasets along axis 0, skipping timepoints already stored."""

    def __init__(self, path: str | Path, group: str = "/"):
        self.path = Path(path)
        self.group = group

    def _ds(self, h5, name: str, sample: np.ndarray):
        full = f"{self.group.rstrip('/')}/{name}"
        if full in h5:
            return h5[full]
        maxshape = (None, *sample.shape)
        return h5.create_dataset(
            full,
            shape=(0, *sample.shape),
            maxshape=maxshape,
            dtype=sample.dtype,
            compression="gzip",
        )

    def written_tps(self, name: str) -> int:
        import h5py

        with h5py.File(self.path, "a") as h5:
            full = f"{self.group.rstrip('/')}/{name}"
            return h5[full].shape[0] if full in h5 else 0

    def append(self, name: str, value, tp: int) -> bool:
        """Write ``value`` as row ``tp``; returns False when already there
        (the reference's duplicate-tp guard, ``writer.py:210-222``)."""
        import h5py

        value = np.asarray(value)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with h5py.File(self.path, "a") as h5:
            ds = self._ds(h5, name, value)
            if tp < ds.shape[0]:
                return False
            ds.resize(tp + 1, axis=0)
            ds[tp] = value
        return True


class TilerH5Writer(DynamicWriter):
    """Trap locations (once) + drift per timepoint."""

    def write(self, tile_locs, tp: int) -> None:
        import h5py

        with h5py.File(self.path, "a") as h5:
            grp = h5.require_group("trap_info")
            if "trap_locations" not in grp:
                grp.create_dataset(
                    "trap_locations", data=np.asarray(tile_locs.initial_centres)
                )
                grp.attrs["tile_size"] = tile_locs.tile_size or 0
        self.append("trap_info/drifts", np.asarray(tile_locs.drifts[-1]), tp)


class StateH5Writer:
    """Tracker-state snapshot for resume (``StateWriter`` semantics)."""

    def __init__(self, path: str | Path):
        self.path = Path(path)

    def write(self, state: dict, tp: int) -> None:
        import h5py

        self.path.parent.mkdir(parents=True, exist_ok=True)
        with h5py.File(self.path, "a") as h5:
            grp = h5.require_group(f"last_state")
            grp.attrs["timepoint"] = tp
            grp.attrs["max_label"] = json.dumps(
                [int(m) for m in state.get("max_label", [])]
            )
            for key in list(grp.keys()):
                del grp[key]
            for i, labels in enumerate(state.get("labels", [])):
                if labels is not None:
                    grp.create_dataset(
                        f"labels_{i}", data=np.asarray(labels), compression="gzip"
                    )


def read_state(path: str | Path) -> dict | None:
    import h5py

    path = Path(path)
    if not path.exists():
        return None
    with h5py.File(path, "r") as h5:
        if "last_state" not in h5:
            return None
        grp = h5["last_state"]
        n = len([k for k in grp if k.startswith("labels_")])
        return {
            "timepoint": int(grp.attrs["timepoint"]),
            "max_label": json.loads(grp.attrs["max_label"]),
            "labels": [np.asarray(grp[f"labels_{i}"]) for i in range(n)],
        }
