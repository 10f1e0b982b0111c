"""In-process BABY-equivalent: yeast segmentation + tracking + lineage
(counterpart of ``aliby_tpu/models/baby.py``).

The reference's BABY is a remote server (``segment/dispatch.py:26-78``)
returning per-tile layered masks plus tracking metadata (track-consistent
``cell_label`` ids and ``mother_assign`` lineage). This module gives the
same contract in process: a base segmenter (``threshold`` by default, on
``device``) makes instance masks, the stitch tracker carried across calls
makes labels track-consistent (on ``device``), masks are spread over
layers, and each new track is assigned a mother by bud-neck contact + size
ratio, with a bounded nearest-centroid fallback for detached births. Once
assigned, a daughter's mother is re-emitted at every later timepoint. The
lineage bookkeeping is host numpy on the tracker's label maps, as in the
reference.
"""

from __future__ import annotations

import numpy as np

from aliby_tpu_torch.device import resolve_device
from aliby_tpu_torch.track.trackers import stitch_rois


def _layered(mask: np.ndarray, n_layers: int) -> np.ndarray:
    """Spread labels over layers (label k -> layer k % n_layers)."""
    out = np.zeros((n_layers, *mask.shape), dtype=mask.dtype)
    for lbl in np.unique(mask):
        if lbl == 0:
            continue
        layer = int(lbl) % n_layers
        out[layer][mask == lbl] = lbl
    return out


def _centroids_and_areas(mask: np.ndarray):
    cents, areas = {}, {}
    for lbl in np.unique(mask):
        if lbl == 0:
            continue
        ys, xs = np.nonzero(mask == lbl)
        cents[int(lbl)] = (float(ys.mean()), float(xs.mean()))
        areas[int(lbl)] = int(ys.size)
    return cents, areas


def _dilate(mask: np.ndarray, iterations: int = 2) -> np.ndarray:
    """Cross-structuring-element binary dilation (no wrap-around)."""
    out = mask.copy()
    for _ in range(iterations):
        grown = out.copy()
        grown[1:] |= out[:-1]
        grown[:-1] |= out[1:]
        grown[:, 1:] |= out[:, :-1]
        grown[:, :-1] |= out[:, 1:]
        out = grown
    return out


def infer_mother(lbl: int, global_map: np.ndarray, areas: dict[int, int],
                 cents: dict[int, tuple[float, float]], candidates: set[int],
                 max_ratio: float = 0.8, max_dist: float = 30.0) -> int:
    """Mother track of a newborn ``lbl``: the touching (bud-neck) cell that
    the bud is markedly smaller than; else the nearest candidate within
    ``max_dist``; else 0. ``candidates`` are the tracks that existed before
    this timepoint (a cell cannot be mothered by a sibling born with it)."""
    new = global_map == lbl
    ring = _dilate(new, 2) & ~new
    neigh = global_map[ring]
    neigh = neigh[neigh > 0]
    best, best_contact = 0, 0
    if neigh.size:
        contact = np.bincount(neigh)
        for cand in np.nonzero(contact)[0]:
            cand = int(cand)
            if cand == lbl or cand not in candidates:
                continue
            if areas.get(lbl, 0) > max_ratio * areas.get(cand, 0):
                continue  # not bud-sized relative to this neighbour
            if contact[cand] > best_contact:
                best, best_contact = cand, int(contact[cand])
    if best:
        return best
    # detached birth (a segmentation gap at the neck): the nearest candidate
    if lbl in cents:
        cy, cx = cents[lbl]
        dists = {
            k: np.hypot(cy - v[0], cx - v[1])
            for k, v in cents.items()
            if k in candidates and k != lbl
            and areas.get(lbl, 0) <= max_ratio * areas.get(k, 0)
        }
        if dists:
            nearest = min(dists, key=dists.get)
            if dists[nearest] <= max_dist:
                return int(nearest)
    return 0


def make_baby_segmenter(channel_to_segment: int = 0, base_kind: str = "threshold",
                        n_layers: int = 3, iou_threshold: float = 0.25,
                        mother_max_ratio: float = 0.8, mother_max_dist: float = 30.0,
                        tiler=None, base_fn=None, device=None, **kwargs):
    """Closure with BABY's result contract.

    Returns per call ``{"masks": [per-tile (n_layers, Y, X) uint16],
    "metadata": {"cell_label": [...], "mother_assign": [...]}}``, where
    ``mother_assign`` entries are 1-based indices into the tile's current
    ``cell_label`` list (0 = none), as ``engine/baby_parser.py`` reads them.
    """
    device = resolve_device(device)
    if base_fn is not None:
        base = base_fn  # an injected segmenter (tests, custom models)
    else:
        from aliby_tpu_torch.models.segment import dispatch_segmenter

        base = dispatch_segmenter(base_kind, channel_to_segment=channel_to_segment,
                                  device=device, **kwargs)
    # per tile: seen tracks, persistent lineage {track: mother track}
    state = {"track": None, "seen": {}, "lineage": {}}

    def segment(pixels=None, tp: int | None = None, **_ignored):
        if pixels is None:
            if tiler is None or tp is None:
                raise ValueError("baby segmenter needs pixels (passed_methods) or an "
                                 "injected tiler + tp")
            pixels = tiler.get_fczyx(tp)
        raw_masks = base(pixels)
        if isinstance(raw_masks, dict):
            raw_masks = raw_masks["masks"]
        # track-consistent relabelling by the stitch tracker
        tile_major = [[m] for m in raw_masks]
        if state["track"] is not None:
            tile_major = [[prev_m, m] for prev_m, m in
                          zip(state["track"]["prev_masks"], raw_masks)]
        track_state = stitch_rois(tile_major, state=state["track"],
                                  iou_threshold=iou_threshold, device=device)
        track_state["prev_masks"] = [np.asarray(m) for m in raw_masks]
        first_call = state["track"] is None
        state["track"] = track_state

        cell_labels, mothers, layered_masks = [], [], []
        for tile_i, global_map in enumerate(track_state["labels"]):
            global_map = np.asarray(global_map)
            cents, areas = _centroids_and_areas(global_map)
            labels = sorted(cents)
            seen: set[int] = state["seen"].setdefault(tile_i, set())
            lineage: dict[int, int] = state["lineage"].setdefault(tile_i, {})
            for lbl in labels:
                if lbl in seen or first_call:
                    continue  # an existing track, or the initial population
                mother = infer_mother(lbl, global_map, areas, cents, candidates=seen,
                                      max_ratio=mother_max_ratio, max_dist=mother_max_dist)
                if mother:
                    lineage[lbl] = mother
            seen.update(labels)
            ma = [labels.index(lineage[lbl]) + 1 if lineage.get(lbl, 0) in labels else 0
                  for lbl in labels]
            cell_labels.append(labels)
            mothers.append(ma)
            layered_masks.append(_layered(global_map.astype(np.uint16), n_layers))
        return {"masks": layered_masks,
                "metadata": {"cell_label": cell_labels, "mother_assign": mothers}}

    return segment
