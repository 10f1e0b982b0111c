"""Stitch tracking: IoU-matched label carry-over (counterpart of
``aliby_tpu/track/trackers.py``).

Per tile, the tracker receives the masks of the last two timepoints and its
carried state ``{"labels": <global label map of tp-1>, "max_label": <int>}``;
the current mask's objects adopt the previous object's global label when
their IoU exceeds the threshold, otherwise they get fresh labels above
``max_label``.

:func:`stitch_pair` takes a batch of images, so :func:`stitch_movie` is a
Python loop over T of one batched call (the reference's ``lax.scan`` over T
and ``vmap`` over tiles) and nothing in it reads a value back to the host:
no ``.item()``, no ``torch.unique`` or ``torch.nonzero``. The (prev x cur)
intersection count goes through the hand-written
``ops.segsum.binned_sum_cols_batched`` (``kernels/csrc/segsum.cu``) on the
card; counts are integers below 2**24, exact in any order. The rest is
dense (B, L, L) tensor code.
"""

from __future__ import annotations

import numpy as np
import torch

from aliby_tpu_torch.device import resolve_device
from aliby_tpu_torch.ops.segsum import binned_sum_cols_batched
from aliby_tpu_torch.ops.labels import relabel_sequential_batched


def stitch_pair(prev_global: torch.Tensor, cur: torch.Tensor, max_label: torch.Tensor,
                max_labels: int = 256, iou_threshold: float = 0.25):
    """Assign global labels to each image of ``cur`` (B, Y, X) by IoU
    against ``prev_global`` (B, Y, X), with per-image ``max_label`` (B,).

    Returns ``(cur_global, new_max)``: (B, Y, X) and (B,) int32, on the
    inputs' device.
    """
    B = cur.shape[0]
    L = max_labels + 1
    prev_c, forward = relabel_sequential_batched(prev_global.to(torch.int32), max_labels)
    cur = cur.to(torch.int32)
    bins = (prev_c * L + cur).reshape(B, -1)
    ones = torch.ones(bins.shape + (1,), dtype=torch.float32, device=cur.device)
    inter = binned_sum_cols_batched(ones, bins, L * L).reshape(B, L, L)
    area_p = inter.sum(2)
    area_c = inter.sum(1)
    union = area_p[:, :, None] + area_c[:, None, :] - inter
    iou = inter / torch.clamp_min(union, 1.0)
    iou[:, 0, :] = 0.0
    iou[:, :, 0] = 0.0
    best_iou = iou.amax(dim=1)
    best_prev = iou.argmax(dim=1)  # first index on ties, as jnp.argmax
    matched = best_iou > torch.tensor(iou_threshold, dtype=torch.float32)
    exists = area_c > 0
    exists[:, 0] = False
    new_rank = torch.cumsum(exists & ~matched, dim=1, dtype=torch.int32)
    max_label = max_label.to(device=cur.device, dtype=torch.int32).reshape(B)
    carried = torch.gather(forward, 1, best_prev.clamp(0, max_labels))
    assigned = torch.where(matched, carried, max_label[:, None] + new_rank)
    lut = torch.where(exists, assigned, 0).to(torch.int32)  # index: cur compact label
    cur_global = torch.gather(lut, 1, cur.reshape(B, -1).clamp(0, max_labels).to(torch.int64))
    new_max = torch.maximum(max_label, lut.amax(dim=1))
    return cur_global.reshape(cur.shape), new_max


def stitch_rois(masks, state: dict | None = None, iou_threshold: float = 0.25,
                max_labels: int = 256, device=None) -> dict:
    """Track all tiles one step forward.

    ``masks``: per-tile list of the last <=2 timepoints' label maps
    (tile-major). ``state``: ``{"labels": [per-tile global maps],
    "max_label": [ints]}``. Returns numpy label maps and python ints; runs
    ``stitch_pair`` on ``device`` (``cuda`` by default).
    """
    device = resolve_device(device)
    if state is None:
        state = {"labels": [None] * len(masks), "max_label": [0] * len(masks)}
    out_labels, out_max = [], []
    for tile_i, tile_masks in enumerate(masks):
        cur = np.asarray(tile_masks[-1])
        prev_state = state["labels"][tile_i]
        max_label = int(state["max_label"][tile_i])
        if prev_state is None or len(tile_masks) < 2:
            # first frame: objects keep their (sequential) ids as globals
            cur_global = cur.astype(np.int32)
            new_max = int(cur_global.max())
        else:
            g, m = stitch_pair(
                torch.from_numpy(np.asarray(prev_state, np.int32))[None].to(device),
                torch.from_numpy(cur.astype(np.int32))[None].to(device),
                torch.tensor([max_label], dtype=torch.int32),
                max_labels=max_labels, iou_threshold=iou_threshold,
            )
            cur_global = g[0].cpu().numpy()
            new_max = int(m[0])
        out_labels.append(cur_global)
        out_max.append(max(new_max, max_label))
    return {"labels": out_labels, "max_label": out_max}


def _first_frame(first: torch.Tensor):
    return first, first.reshape(first.shape[0], -1).amax(dim=1)


def stitch_sequence(masks_t: torch.Tensor, max_labels: int = 256,
                    iou_threshold: float = 0.25) -> torch.Tensor:
    """Whole-sequence tracking: (T, Y, X) per-frame label maps -> (T, Y, X)
    global maps, the first frame keeping its own ids."""
    g, m = _first_frame(masks_t[:1].to(torch.int32))
    out = [g]
    for t in range(1, masks_t.shape[0]):
        g, m = stitch_pair(g, masks_t[t:t + 1], m, max_labels=max_labels,
                           iou_threshold=iou_threshold)
        out.append(g)
    return torch.cat(out)


def stitch_movie(masks_tf: torch.Tensor, init_labels: torch.Tensor, init_max: torch.Tensor,
                 has_init, max_labels: int = 256, iou_threshold: float = 0.25):
    """Whole-movie tracking for a batch of tiles: a loop over T of one
    batched :func:`stitch_pair`.

    ``masks_tf``: (T, F, Y, X) per-frame label maps. ``init_labels`` /
    ``init_max``: (F, Y, X) / (F,) carried tracker state from a previous
    chunk; ``has_init`` (a bool, or a bool tensor of shape () or (F,))
    selects, per tile, between continuing from that state and the
    first-frame rule (objects keep their sequential ids as globals, the
    ``stitch_rois`` semantics). Both are computed and one is selected, so
    nothing waits on the host.

    Returns (globals_tf, max_t): (T, F, Y, X) global label maps and the
    (T, F) running max label after each frame, exactly the per-tp
    ``{"labels", "max_label"}`` states of the per-tp path.
    """
    dev = masks_tf.device
    F = masks_tf.shape[1]
    if isinstance(has_init, torch.Tensor):
        has = has_init.to(device=dev, dtype=torch.bool).reshape(-1).expand(F)
    else:  # a fill on the device, not a copy from the host
        has = torch.full((F,), bool(has_init), dtype=torch.bool, device=dev)
    first = masks_tf[0].to(torch.int32)
    init_labels = init_labels.to(device=dev, dtype=torch.int32)
    init_max = init_max.to(device=dev, dtype=torch.int32).reshape(F)
    g_init, m_init = stitch_pair(init_labels, first, init_max, max_labels=max_labels,
                                 iou_threshold=iou_threshold)
    g_first, m_first = _first_frame(first)
    g = torch.where(has[:, None, None], g_init, g_first)
    m = torch.where(has, m_init, m_first)
    globals_t, max_t = [g], [m]
    for t in range(1, masks_tf.shape[0]):
        g, m = stitch_pair(g, masks_tf[t], m, max_labels=max_labels,
                           iou_threshold=iou_threshold)
        globals_t.append(g)
        max_t.append(m)
    return torch.stack(globals_t), torch.stack(max_t)
