"""Signal: post-hoc time-series queries over the profiles parquet
(counterpart of ``aliby_tpu/postprocess/signal.py``; pandas and pyarrow are
imported where a parquet is read or a frame is made).

The Parquet-era successor of the reference's h5-backed ``Signal``
(``agora/io/signal.py:20-389``, import-broken as shipped): one object per
position output directory; any profile column becomes a (cell x time)
DataFrame; tracking/lineage parquets drive merge/pick modifiers.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from aliby_tpu_torch.postprocess.indexing import apply_merges, validate_lineage


def _read_parquet(f: Path) -> pd.DataFrame:
    import pyarrow.parquet as pq

    return pq.read_table(f).to_pandas()


class Signal:
    def __init__(self, output_path: str | Path, position: str):
        self.output_path = Path(output_path)
        self.position = position
        self._profiles: pd.DataFrame | None = None

    @property
    def profiles(self) -> pd.DataFrame:
        if self._profiles is None:
            self._profiles = _read_parquet(
                self.output_path / "profiles" / f"{self.position}.parquet")
        return self._profiles

    @property
    def columns(self) -> list[str]:
        return [
            c for c in self.profiles.columns if not c.startswith("metadata_")
        ]

    def get(
        self,
        column: str,
        metadata_object: str | None = None,
    ) -> pd.DataFrame:
        """(tile, label) x timepoint matrix of one metric."""
        df = self.profiles
        if metadata_object is not None:
            df = df[df["metadata_object"] == metadata_object]
        pivot = df.pivot_table(
            index=["metadata_tile", "metadata_label"],
            columns="metadata_tp",
            values=column,
            aggfunc="first",
        )
        pivot.index.names = ["tile", "label"]
        pivot.columns.name = "timepoint"
        return pivot

    __getitem__ = get

    # -- tracking-aware modifiers ------------------------------------------

    def tracking(self, step: str = "segment_cell") -> pd.DataFrame | None:
        f = self.output_path / "tracking" / f"{self.position}_{step}.parquet"
        return _read_parquet(f) if f.exists() else None

    def lineage(self, step: str = "segment_cell") -> np.ndarray:
        """(M, 2, 2) array of ((tile, mother), (tile, daughter)) pairs."""
        track = self.tracking(step)
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
        return np.stack(
            [pairs[:, [0, 1]], pairs[:, [0, 2]]], axis=1
        )

    def get_with_lineage(
        self, column: str, metadata_object: str | None = None, step: str = "segment_cell"
    ) -> tuple[pd.DataFrame, np.ndarray]:
        """Metric matrix restricted to cells in validated mother-bud pairs."""
        matrix = self.get(column, metadata_object)
        index = np.asarray([list(ix) for ix in matrix.index])
        lineage = self.lineage(step)
        valid, involved = validate_lineage(lineage, index)
        return matrix[involved], valid

    def merge_tracks(
        self, matrix: pd.DataFrame, merges: np.ndarray
    ) -> pd.DataFrame:
        """Splice merged track segments (see indexing.apply_merges)."""
        import pandas as pd

        index = np.asarray([list(ix) for ix in matrix.index])
        values, keep = apply_merges(matrix.to_numpy(), index, merges)
        out = pd.DataFrame(values, index=matrix.index, columns=matrix.columns)
        return out[keep]

    def retained(self, matrix: pd.DataFrame, fraction: float = 0.8) -> pd.DataFrame:
        """Keep cells present in at least ``fraction`` of timepoints."""
        presence = matrix.notna().mean(axis=1)
        return matrix[presence >= fraction]
