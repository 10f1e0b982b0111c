"""Cells: post-hoc mask/label queries over per-tp npz checkpoints
(counterpart of ``aliby_tpu/postprocess/cells.py``; host numpy, outlines
through the port's ``extract.reductions.boundary_mask`` on the CPU,
pyarrow imported where the tracking parquet is read).

The Parquet/npz-era successor of the reference's h5 ``Cells``
(``agora/io/cells.py:16-437``): masks and labels at a timepoint, per-tile
label inventories, presence matrices, and mother-daughter matrices from
the tracking parquet.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from aliby_tpu_torch.extract.reductions import boundary_mask


def _outline(mask: np.ndarray) -> np.ndarray:
    """Boolean outline of a 2-D label map (4-connectivity)."""
    return boundary_mask(torch.from_numpy(np.asarray(mask, np.int32))).numpy()


class Cells:
    def __init__(self, output_path: str | Path, position: str, step: str = "segment_cell"):
        self.output_path = Path(output_path)
        self.position = position
        self.step = step
        self.step_dir = self.output_path / "steps" / position / step

    @property
    def ntimepoints(self) -> int:
        return len(sorted(self.step_dir.glob("*.npz")))

    def _load(self, tp: int) -> list[np.ndarray]:
        f = self.step_dir / f"{tp:04d}.npz"
        with np.load(f) as npz:
            keys = sorted(npz.keys())
            if "tile_0" in keys:
                return [npz[k] for k in sorted(
                    (k for k in keys if k.startswith("tile_")),
                    key=lambda s: int(s.split("_")[1]),
                )]
            return list(npz["arr_0"])

    def masks_at_time(self, tp: int) -> list[np.ndarray]:
        """Per-tile 2-D label maps (layered BABY masks are max-projected —
        safe: layers never overlap per pixel)."""
        out = []
        for m in self._load(tp):
            m = np.asarray(m)
            out.append(m.max(axis=0) if m.ndim == 3 else m)
        return out

    def labels_at_time(self, tp: int) -> dict[int, list[int]]:
        return {
            tile_i: [int(l) for l in np.unique(m) if l]
            for tile_i, m in enumerate(self.masks_at_time(tp))
        }

    @property
    def labels(self) -> list[list[int]]:
        """Per-tile union of labels across all timepoints."""
        per_tile: dict[int, set] = {}
        for tp in range(self.ntimepoints):
            for tile_i, labels in self.labels_at_time(tp).items():
                per_tile.setdefault(tile_i, set()).update(labels)
        return [sorted(per_tile[k]) for k in sorted(per_tile)]

    def presence_matrix(self, tile: int = 0) -> np.ndarray:
        """(n_labels, T) bool presence of each label per timepoint."""
        ntps = self.ntimepoints
        all_labels = self.labels[tile] if self.labels else []
        out = np.zeros((len(all_labels), ntps), bool)
        lut = {l: i for i, l in enumerate(all_labels)}
        for tp in range(ntps):
            for l in self.labels_at_time(tp).get(tile, []):
                out[lut[l], tp] = True
        return out

    def outlines_at_time(self, tp: int) -> list[np.ndarray]:
        """Per-tile boolean outlines (label boundaries)."""
        return [_outline(m) for m in self.masks_at_time(tp)]

    # -- time-range and per-cell queries (reference cells.py:154-295) -------

    def at_time(self, tp: int, kind: str = "mask") -> dict[int, list[np.ndarray]]:
        """{tile: [per-cell binary masks]} at one timepoint.

        ``kind='mask'`` gives filled masks, ``'edgemask'`` outlines.
        """
        out: dict[int, list[np.ndarray]] = {}
        for tile_i, m in enumerate(self.masks_at_time(tp)):
            cells = []
            for lbl in np.unique(m):
                if not lbl:
                    continue
                filled = m == lbl
                if kind == "edgemask":
                    cells.append(_outline(filled))
                else:
                    cells.append(filled)
            out[tile_i] = cells
        return out

    def at_times(self, timepoints, kind: str = "mask") -> list[list[np.ndarray]]:
        """Per-tp list of per-tile stacked cell masks (reference at_times)."""
        return [
            [
                np.stack(tile_masks) if len(tile_masks) else []
                for tile_masks in self.at_time(tp, kind=kind).values()
            ]
            for tp in timepoints
        ]

    def where(self, cell_label: int, tile: int):
        """(timepoints, per-tp boolean masks) where the cell appears."""
        tps, masks = [], []
        for tp in range(self.ntimepoints):
            m = self.masks_at_time(tp)
            if tile < len(m) and (m[tile] == cell_label).any():
                tps.append(tp)
                masks.append(m[tile] == cell_label)
        return np.asarray(tps), np.asarray(masks)

    def mask(self, cell_label: int, tile: int):
        return self.where(cell_label, tile)

    def outline(self, cell_label: int, tile: int):
        tps, masks = self.where(cell_label, tile)
        return tps, np.asarray([_outline(m) for m in masks])

    def cell_labels_in_trap(self, tile: int) -> set:
        labels = self.labels
        return set(labels[tile]) if tile < len(labels) else set()

    def nonempty_tp_in_trap(self, tile: int) -> set:
        return {
            tp
            for tp in range(self.ntimepoints)
            if self.labels_at_time(tp).get(tile)
        }

    @property
    def ntraps(self) -> int:
        return len(self.masks_at_time(0)) if self.ntimepoints else 0

    @property
    def max_labels(self) -> list[int]:
        return [max(l) if l else 0 for l in self.labels]

    @property
    def max_label(self) -> int:
        return max(self.max_labels, default=0)

    # -- presence matrices + sliding-window retention ------------------------

    @property
    def cells_vs_tps(self) -> np.ndarray:
        """(total_cells, T) bool presence, cells ordered tile-major."""
        labels = self.labels
        ntps = self.ntimepoints
        index = {}
        for tile_i, tile_labels in enumerate(labels):
            for lbl in tile_labels:
                index[(tile_i, lbl)] = len(index)
        out = np.zeros((len(index), ntps), bool)
        for tp in range(ntps):
            for tile_i, tile_labels in self.labels_at_time(tp).items():
                for lbl in tile_labels:
                    out[index[(tile_i, lbl)], tp] = True
        return out

    @property
    def tiles_vs_cells_vs_tps(self) -> np.ndarray:
        """(ntraps, max_label, T) bool presence (reference property)."""
        ntps = self.ntimepoints
        out = np.zeros((self.ntraps, self.max_label, ntps), bool)
        for tp in range(ntps):
            for tile_i, tile_labels in self.labels_at_time(tp).items():
                for lbl in tile_labels:
                    out[tile_i, lbl - 1, tp] = True
        return out

    def cell_tp_where(
        self,
        min_consecutive_tps: int = 15,
        interval: tuple[int, int] | None = None,
    ) -> np.ndarray:
        """Sliding-window retention (reference cells.py:273-295): for every
        cell, the window starts where it is present for
        ``min_consecutive_tps`` consecutive tps; optionally restricted to
        an interval."""
        from numpy.lib.stride_tricks import sliding_window_view

        cvt = self.cells_vs_tps
        w = min(min_consecutive_tps, cvt.shape[1])
        window = sliding_window_view(cvt, w, axis=1)
        tp_min = window.sum(axis=-1) == w
        lo, hi = interval if interval is not None else (0, tp_min.shape[1])
        tp_min[:, :lo] = False
        tp_min[:, hi:] = False
        return tp_min

    def retained(self, min_consecutive_tps: int = 15) -> np.ndarray:
        """(total_cells,) bool: cells with any qualifying retention window."""
        return self.cell_tp_where(min_consecutive_tps).any(axis=1)

    # -- lineage ------------------------------------------------------------

    def mothers_in_trap(self, tile: int) -> list[int]:
        """Mother labels observed in one tile's tracking parquet."""
        return sorted(
            {int(m) for (t0, m), _ in self.mothers_daughters() if t0 == tile}
        )

    def _tracking(self):
        f = self.output_path / "tracking" / f"{self.position}_{self.step}.parquet"
        if not f.exists():
            return None
        import pyarrow.parquet as pq

        return pq.read_table(f).to_pandas()

    def mothers_daughters(self) -> np.ndarray:
        """(M, 2, 2) of ((tile, mother_label), (tile, daughter_label))."""
        track = self._tracking()
        if track is None:
            return np.zeros((0, 2, 2), int)
        pairs = (
            track[track["mother_label"] > 0][
                ["tile", "mother_label", "cell_label"]
            ]
            .drop_duplicates()
            .to_numpy()
        )
        if not len(pairs):
            return np.zeros((0, 2, 2), int)
        return np.stack([pairs[:, [0, 1]], pairs[:, [0, 2]]], axis=1)

    def mothers_daughters_matrix(self, tile: int = 0) -> np.ndarray:
        """(n_labels, n_labels) bool adjacency: mother row -> daughter col."""
        labels = self.labels[tile] if self.labels else []
        lut = {l: i for i, l in enumerate(labels)}
        out = np.zeros((len(labels), len(labels)), bool)
        for (t0, mother), (t1, daughter) in self.mothers_daughters():
            if t0 == tile and mother in lut and daughter in lut:
                out[lut[mother], lut[daughter]] = True
        return out
