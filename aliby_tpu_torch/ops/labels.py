"""Label-map utilities (counterpart of ``aliby_tpu/ops/labels.py``).

Ported: :func:`relabel_dense` (segmentation), :func:`relabel_sequential`
and its batched form (tracking), :func:`num_labels` and
:func:`to_uint16_labels`. ``connected_components*``, ``label_onehot`` and
``segment_sum`` come with the ``threshold`` segmenter (ROADMAP queue 1,
item 4).
"""

from __future__ import annotations

import numpy as np
import torch

_BIG = 2**30  # the reference's sentinel: labels lie below it


def relabel_dense(labels: torch.Tensor, upper: int, max_labels: int) -> torch.Tensor:
    """Compact positive labels known to lie in [0, upper) into 1..n per image.

    ``labels`` is (B, ...). Order is ascending original label; labels whose
    sequential id would exceed ``max_labels`` map to 0 (dropped).
    """
    B = labels.shape[0]
    flat = labels.reshape(B, -1)
    idx = flat.clamp(0, upper - 1).to(torch.int64)
    present = torch.zeros(B, upper, dtype=torch.int32, device=labels.device)
    present.scatter_reduce_(1, idx, (flat > 0).to(torch.int32), "amax")
    seq = torch.cumsum(present, dim=1, dtype=torch.int32)
    new = torch.gather(seq, 1, idx)
    new = torch.where((flat > 0) & (new <= max_labels), new, 0)
    return new.reshape(labels.shape).to(torch.int32)


def relabel_sequential_batched(labels: torch.Tensor, max_labels: int):
    """:func:`relabel_sequential` of each image of a (B, ...) batch.

    Returns ``(relabeled, forward)``: (B, ...) int32 and (B, max_labels + 1)
    of ``labels``' dtype. Bit for bit the reference's
    ``jnp.unique(size=max_labels + 1, fill_value=2**30)`` + ``searchsorted``
    form, for labels below 2**30, with fixed-size work and no host
    synchronisation: one sort per image, a first-of-run mark and a cumsum
    give each pixel the index ``u`` of its value among the image's distinct
    values. The reference keeps the ``S = max_labels + 1`` smallest distinct
    values, so a pixel's rank is ``min(u, max_labels)``, and its sequential
    id counts the positive kept values up to that rank: with ``p0`` distinct
    values <= 0 in the image, ``max(min(u, max_labels) - p0 + 1, 0)``.
    ``forward[k]`` is the ``k``-th positive kept value, for ``k <= max_labels``.
    """
    B = labels.shape[0]
    S = max_labels + 1
    flat = labels.reshape(B, -1)
    sorted_v, perm = torch.sort(flat, dim=1)
    first = torch.ones_like(sorted_v, dtype=torch.bool)
    first[:, 1:] = sorted_v[:, 1:] != sorted_v[:, :-1]
    u = torch.cumsum(first, dim=1, dtype=torch.int32) - 1  # distinct index, 0-based
    p0 = (first & (sorted_v <= 0)).sum(dim=1, dtype=torch.int32).unsqueeze(1)
    seq = torch.clamp_min(torch.clamp_max(u, max_labels) - p0 + 1, 0)
    new_sorted = torch.where(sorted_v > 0, seq, 0)
    new = torch.empty_like(new_sorted).scatter_(1, perm, new_sorted)
    # forward: each positive kept value at its sequential id; the rest to a spare slot
    slot = torch.where(first & (sorted_v > 0) & (u < S) & (seq <= max_labels), seq, S)
    forward = torch.zeros(B, S + 1, dtype=labels.dtype, device=labels.device)
    forward.scatter_(1, slot.to(torch.int64), sorted_v)
    forward = forward[:, :S].contiguous()
    forward[:, 0] = 0
    return new.reshape(labels.shape), forward


def relabel_sequential(labels: torch.Tensor, max_labels: int):
    """Compact arbitrary positive labels into 1..n (n <= max_labels).

    Returns ``(relabeled, forward)`` where ``forward[k]`` is the original
    label mapped to sequential id ``k`` (0 entries unused). Ordering follows
    ascending original label, as ``skimage.segmentation.relabel_sequential``.
    """
    new, forward = relabel_sequential_batched(labels.unsqueeze(0), max_labels)
    return new[0], forward[0]


def num_labels(labels):
    return labels.max()


def to_uint16_labels(arr) -> np.ndarray:
    """Overflow-guarded cast to uint16 (reference ``segment/dispatch.py:14-19``)."""
    a = arr.cpu().numpy() if isinstance(arr, torch.Tensor) else np.asarray(arr)
    if int(a.max()) > np.iinfo(np.uint16).max:
        raise ValueError("Label overflow: more than 65535 objects in a tile.")
    return a.astype(np.uint16)
