"""BABY tracking/lineage metadata accumulation (counterpart of
``aliby_tpu/engine/baby_parser.py``).

Reference (``segment/baby_parser.py:36-128``): every BABY segmentation
result carries per-tile ``cell_label`` (track-consistent ids) and
``mother_assign`` (the mother's 1-based index into the labels, 0 = none);
these fold across timepoints into one long table (tile, timepoint,
cell_label, mother_label). :func:`baby_tracking_columns` gives it as numpy
columns (no pyarrow needed); :func:`baby_tracking_to_table` wraps them in a
pyarrow table (pyarrow imported there only).
"""

from __future__ import annotations

import numpy as np

TRACKING_COLUMNS = ("tile", "timepoint", "cell_label", "mother_label")


def accumulate_tracking(per_tp_metadata: list[dict]) -> dict:
    """{(tile, tp): [cell labels]} from per-tp metadata records."""
    tracking: dict = {}
    for tp, meta in enumerate(per_tp_metadata):
        if not meta:
            continue
        for tile_i, labels in enumerate(meta.get("cell_label", [])):
            tracking[(tile_i, tp)] = list(labels)
    return tracking


def accumulate_lineage(per_tp_metadata: list[dict]) -> dict:
    """{(tile, tp): [(cell_label, mother_label)]}; mother 0 = none."""
    lineage: dict = {}
    for tp, meta in enumerate(per_tp_metadata):
        if not meta:
            continue
        cell_labels = meta.get("cell_label", [])
        mothers = meta.get("mother_assign", [])
        for tile_i, labels in enumerate(cell_labels):
            ma = mothers[tile_i] if tile_i < len(mothers) else [0] * len(labels)
            pairs = []
            for j, lbl in enumerate(labels):
                mother_idx = ma[j] if j < len(ma) else 0
                # mother_assign is 1-based into the label list; 0 = none
                mother_label = labels[mother_idx - 1] if 0 < mother_idx <= len(labels) else 0
                pairs.append((lbl, mother_label))
            lineage[(tile_i, tp)] = pairs
    return lineage


def baby_tracking_columns(per_tp_metadata: list[dict]) -> dict:
    """The long table (tile, timepoint, cell_label, mother_label) as int64
    numpy columns."""
    tracking = accumulate_tracking(per_tp_metadata)
    lineage = accumulate_lineage(per_tp_metadata)
    rows = {k: [] for k in TRACKING_COLUMNS}
    for (tile_i, tp), labels in tracking.items():
        pairs = dict(lineage.get((tile_i, tp), []))
        for lbl in labels:
            rows["tile"].append(int(tile_i))
            rows["timepoint"].append(int(tp))
            rows["cell_label"].append(int(lbl))
            rows["mother_label"].append(int(pairs.get(lbl, 0)))
    return {k: np.asarray(v, np.int64) for k, v in rows.items()}


def baby_tracking_to_table(per_tp_metadata: list[dict]):
    """:func:`baby_tracking_columns` as a ``pyarrow.Table``."""
    import pyarrow as pa

    return pa.Table.from_pydict(baby_tracking_columns(per_tp_metadata))
