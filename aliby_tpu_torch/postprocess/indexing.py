"""Track-index utilities: intersection, merging, lineage validation (a
copy of ``aliby_tpu/postprocess/indexing.py``, numpy only).

Modernized equivalents of the reference's legacy helpers
(``agora/utils/indexing.py:8-170``, ``merge.py:14-182``), operating on
integer (tile, cell_label) index arrays instead of h5-era structured
dtypes. Semantics preserved:

- ``index_isin``: row-wise membership of one (N, k) index array in another;
- ``group_merges``: chains of pairwise merges -> connected merge groups;
- ``join_two_tracks`` / ``apply_merges``: splice later track segments onto
  the earlier track's identity in a (index x time) value matrix;
- ``validate_lineage``: keep only mother-bud pairs whose members exist in
  the signal index, preserving order.
"""

from __future__ import annotations

import numpy as np


def index_isin(index: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """Boolean mask of rows of ``index`` present in ``targets`` (both (N, k))."""
    index = np.atleast_2d(np.asarray(index))
    targets = np.atleast_2d(np.asarray(targets))
    if not len(targets):
        return np.zeros(len(index), dtype=bool)
    a = np.ascontiguousarray(index).view(
        [("", index.dtype)] * index.shape[1]
    ).reshape(-1)
    b = np.ascontiguousarray(targets).view(
        [("", targets.dtype)] * targets.shape[1]
    ).reshape(-1)
    return np.isin(a, b)


def group_merges(merges: np.ndarray) -> list[np.ndarray]:
    """Group pairwise (source, target) merges into chains.

    ``merges`` is (M, 2, k): each row merges track ``merges[i, 0]`` into
    ``merges[i, 1]``. Chains (a->b, b->c) come back as one ordered group.
    """
    merges = np.asarray(merges)
    if merges.ndim == 2:
        merges = merges[:, :, None]
    parent: dict[tuple, tuple] = {}

    def find(x):
        while parent.get(x, x) != x:
            parent[x] = parent.get(parent[x], parent[x])
            x = parent[x]
        return x

    for src, dst in ((tuple(m[0]), tuple(m[1])) for m in merges):
        rs, rd = find(src), find(dst)
        if rs != rd:
            parent[rs] = rd
    groups: dict[tuple, list] = {}
    for m in merges:
        root = find(tuple(m[0]))
        groups.setdefault(root, []).append(m)
    return [np.stack(g) for g in groups.values()]


def join_two_tracks(
    values: np.ndarray, earlier_row: int, later_row: int
) -> np.ndarray:
    """Copy the later track's non-NaN span onto the earlier track's row."""
    out = values.copy()
    later = out[later_row]
    mask = ~np.isnan(later)
    out[earlier_row, mask] = later[mask]
    out[later_row] = np.nan
    return out


def apply_merges(
    values: np.ndarray, index: np.ndarray, merges: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Splice merged tracks in a (rows x time) matrix.

    Returns (values, keep_mask): merged-away rows are NaNed and flagged
    False in ``keep_mask``.
    """
    values = np.asarray(values, float).copy()
    index = np.atleast_2d(np.asarray(index))
    keep = np.ones(len(index), dtype=bool)
    lut = {tuple(row): i for i, row in enumerate(index)}
    merges = np.asarray(merges)
    if merges.ndim == 2:
        merges = merges[:, :, None]
    for src, dst in ((tuple(m[0]), tuple(m[1])) for m in merges):
        if src not in lut or dst not in lut:
            continue
        i_dst, i_src = lut[dst], lut[src]
        values = join_two_tracks(values, i_dst, i_src)
        keep[i_src] = False
    return values, keep


def validate_lineage(
    lineage: np.ndarray, index: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Filter mother-bud pairs to those fully present in ``index``.

    ``lineage`` is (M, 2, k) of (mother_index, bud_index) rows; returns
    (valid_lineage_rows, mask_of_index_rows_involved).

    Reference rule (``agora/utils/indexing.py:16-21``): a bud should not
    have two mothers — later assignments of an already-assigned bud are
    discarded (first mother wins) before presence filtering.
    """
    lineage = np.asarray(lineage)
    index = np.atleast_2d(np.asarray(index))
    seen: set = set()
    first_mother = np.ones(len(lineage), dtype=bool)
    for i, row in enumerate(lineage):
        key = tuple(np.asarray(row[1]).ravel())
        if key in seen:
            first_mother[i] = False
        seen.add(key)
    mothers_ok = index_isin(lineage[:, 0], index)
    buds_ok = index_isin(lineage[:, 1], index)
    valid = mothers_ok & buds_ok & first_mother
    kept = lineage[valid]
    involved = index_isin(
        index, kept.reshape(-1, kept.shape[-1]) if len(kept) else kept
    )
    return kept, involved
