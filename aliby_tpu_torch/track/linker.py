"""Global (whole-movie) track linking, the in-process trackastra stand-in
(counterpart of ``aliby_tpu/track/linker.py``).

All tiles' (T, Y, X) mask stacks are stitched as one batch on the device
(:func:`~aliby_tpu_torch.track.trackers.stitch_movie` with the first-frame
rule), and the long-form tracks table carries the tile id (tp, tile,
original label, track id, centroid). :func:`link_tracks_columns` returns
it as numpy columns; :func:`link_tracks` wraps them in a ``pyarrow.Table``
for the callers that ask for one, so the GPU hosts of the port need no
pyarrow.
"""

from __future__ import annotations

import numpy as np
import torch

from aliby_tpu_torch.device import resolve_device
from aliby_tpu_torch.track.trackers import stitch_movie


def _rows_for_tile(rows: dict, orig_t: np.ndarray, glob_t: np.ndarray, tile: int) -> None:
    for tp in range(orig_t.shape[0]):
        orig = orig_t[tp]
        glob = glob_t[tp]
        for lbl in np.unique(orig):
            if lbl == 0:
                continue
            sel = orig == lbl
            ys, xs = np.nonzero(sel)
            track = int(np.bincount(glob[sel]).argmax())
            rows["timepoint"].append(int(tp))
            rows["tile"].append(int(tile))
            rows["label"].append(int(lbl))
            rows["track_id"].append(track)
            rows["centroid_y"].append(float(ys.mean()))
            rows["centroid_x"].append(float(xs.mean()))


TRACK_COLUMNS = ("timepoint", "tile", "label", "track_id", "centroid_y", "centroid_x")


def link_tracks_columns(masks_t: np.ndarray, images_t: np.ndarray | None = None, tile: int = 0,
                        max_labels: int = 256, iou_threshold: float = 0.25,
                        device=None) -> dict:
    """(T, Y, X) or (T, F, Y, X) label maps -> the long tracks table as
    ordered numpy columns (int64 ``timepoint``, ``tile``, ``label``,
    ``track_id``; float64 centroids). Tiles are stitched independently, on
    ``device`` (``cuda`` by default)."""
    device = resolve_device(device)
    masks_t = np.asarray(masks_t)
    mono = masks_t.ndim == 3
    if mono:
        masks_t = masks_t[:, None]  # (T, 1, Y, X)
    F = masks_t.shape[1]
    zeros = torch.zeros((F,) + masks_t.shape[2:], dtype=torch.int32, device=device)
    global_tf, _ = stitch_movie(
        torch.from_numpy(masks_t.astype(np.int32)).to(device), zeros,
        torch.zeros(F, dtype=torch.int32, device=device), False,
        max_labels=max_labels, iou_threshold=float(iou_threshold),
    )
    global_ft = np.moveaxis(global_tf.cpu().numpy(), 1, 0)  # (F, T, Y, X)
    masks_ft = np.moveaxis(masks_t, 1, 0)
    rows = {k: [] for k in TRACK_COLUMNS}
    # track ids are per tile; offset them so they are unique across the position
    base = 0
    for f in range(F):
        glob = global_ft[f]
        if base:
            glob = np.where(glob > 0, glob + base, 0)
        _rows_for_tile(rows, masks_ft[f], glob, tile if mono else f)
        base += int(global_ft[f].max())
    return {k: np.asarray(v, np.float64 if k.startswith("centroid") else np.int64)
            for k, v in rows.items()}


def link_tracks(masks_t: np.ndarray, images_t: np.ndarray | None = None, tile: int = 0,
                max_labels: int = 256, iou_threshold: float = 0.25, device=None):
    """:func:`link_tracks_columns` as a ``pyarrow.Table`` (the reference's
    return value)."""
    import pyarrow as pa

    cols = link_tracks_columns(masks_t, images_t, tile=tile, max_labels=max_labels,
                               iou_threshold=iou_threshold, device=device)
    return pa.Table.from_pydict({k: v.tolist() for k, v in cols.items()})
