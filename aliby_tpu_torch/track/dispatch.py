"""Tracker dispatch (counterpart of ``aliby_tpu/track/dispatch.py``)."""

from __future__ import annotations

from functools import partial

from aliby_tpu_torch.track.trackers import stitch_rois


def dispatch_tracker(kind: str = "stitch", device=None, **kwargs):
    """``stitch``: :func:`stitch_rois` on ``device`` (``cuda`` by default)
    with the step's ``iou_threshold`` and ``max_labels``; ``baby``: the
    closure that surfaces the session's tracker state."""
    if kind == "stitch":
        allowed = {k: v for k, v in kwargs.items() if k in ("iou_threshold", "max_labels")}
        return partial(stitch_rois, device=device, **allowed)
    if kind == "baby":
        # BABY carries its own tracking server-side; the closure surfaces the
        # session's tracker state
        def baby_tracker(masks, state=None, **_):
            return state or {}

        return baby_tracker
    raise ValueError(f"Unknown tracker kind {kind!r}")
