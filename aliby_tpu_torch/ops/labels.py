"""Label-map utilities (counterpart of ``aliby_tpu/ops/labels.py``).

Batched over a leading axis: :func:`connected_components` (the reference's
fixed iterations, the same ids) and :func:`connected_components_hybrid`
(local rounds, then hook rounds until stable; no caller on a path, as in
the reference), :func:`relabel_dense` (segmentation),
:func:`relabel_sequential` and its batched form (tracking),
:func:`label_onehot`, :func:`segment_sum`, :func:`num_labels`,
:func:`to_uint16_labels`, and :func:`fill_label_holes` (segmentation's last
stage: the plain version for CPU tensors, ``kernels/csrc/holes.cu`` for
CUDA tensors, no fallback between the two).
"""

from __future__ import annotations

import numpy as np
import torch

from aliby_tpu_torch.kernels import _build
from aliby_tpu_torch.ops.stencil import shift

_BIG = 2**30  # the reference's sentinel: labels lie below it
FILL_LAUNCHES = 5  # fill_label_holes on the card: bounds, init, link, fold, write


def _neighbor_min(lbl: torch.Tensor, connectivity: int) -> torch.Tensor:
    """Min over each pixel and its 4- or 8-neighbourhood of (B, H, W),
    ``_BIG`` outside the image."""
    B, H, W = lbl.shape
    pad = torch.nn.functional.pad(lbl, (1, 1, 1, 1), value=_BIG)
    offs = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    if connectivity == 2:
        offs += [(-1, -1), (-1, 1), (1, -1), (1, 1)]
    out = lbl
    for dy, dx in offs:
        out = torch.minimum(out, pad[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W])
    return out


def _jump(flat: torch.Tensor, hw: int) -> torch.Tensor:
    """One pointer jump: ``min(p, p[p])`` on the labelled pixels."""
    nxt = torch.gather(flat, 1, flat.clamp(0, hw - 1).to(torch.int64))
    return torch.where(flat < _BIG, torch.minimum(flat, nxt), flat.new_full((), _BIG))


def _hook_round(lbl: torch.Tensor, mask: torch.Tensor, connectivity: int) -> torch.Tensor:
    """One hook + pointer-jump round of (B, H, W) labels (the reference's
    ``connected_components`` body): the neighbourhood min, every pixel's
    best neighbour label hooked into its current root (a scatter-min), the
    neighbour min adopted, two pointer jumps."""
    B, H, W = lbl.shape
    hw = H * W
    big = torch.full((), _BIG, dtype=torch.int32, device=lbl.device)
    nflat = torch.where(mask, _neighbor_min(lbl, connectivity), big).reshape(B, hw)
    flat = lbl.reshape(B, hw)
    valid = flat < _BIG
    roots = torch.where(valid, flat.clamp(0, hw - 1), hw - 1).to(torch.int64)
    flat = flat.scatter_reduce(1, roots, torch.where(valid, nflat, big), "amin")
    flat = torch.minimum(flat, nflat)
    return _jump(_jump(flat, hw), hw).reshape(B, H, W)


def _pixel_ids(mask: torch.Tensor) -> torch.Tensor:
    """Each foreground pixel's flat index, ``_BIG`` on the background."""
    B, H, W = mask.shape
    iota = torch.arange(H * W, dtype=torch.int32, device=mask.device).reshape(1, H, W)
    return torch.where(mask, iota, torch.full((), _BIG, dtype=torch.int32, device=mask.device))


def connected_components(mask: torch.Tensor, connectivity: int = 1, n_iter: int = 24) -> torch.Tensor:
    """Label the connected foreground of each (B, H, W) mask.

    The reference's ``n_iter`` hook + pointer-jump rounds exactly, converged
    or not. A finished component carries the flat index of its smallest
    pixel + 1 (background 0); a component that ``n_iter`` rounds do not
    finish keeps the reference's partial ids."""
    mask = mask.to(torch.bool)
    lbl = _pixel_ids(mask)
    for _ in range(n_iter):
        lbl = _hook_round(lbl, mask, connectivity)
    return torch.where(mask, lbl + 1, torch.zeros((), dtype=torch.int32, device=mask.device))


def connected_components_hybrid(mask: torch.Tensor, connectivity: int = 2, n_local: int = 8,
                                max_hook: int = 64) -> torch.Tensor:
    """Connected components of each (B, H, W) mask for mostly-small
    components, with the reference's ids (min pixel index + 1).

    Phase 1: ``n_local`` rounds of neighbour-min propagation. Phase 2: one
    hook + pointer-jump round, then more while any label still changes, at
    most ``max_hook`` rounds in all (the reference's ``while_loop``; a
    round on a finished image changes nothing, so a batch runs until its
    last image is done). Each phase-2 round reads its change flag on the
    host."""
    mask = mask.to(torch.bool)
    big = torch.full((), _BIG, dtype=torch.int32, device=mask.device)
    lbl = _pixel_ids(mask)
    for _ in range(n_local):
        lbl = torch.where(mask, _neighbor_min(lbl, connectivity), big)
    for _ in range(max(1, max_hook)):
        new = _hook_round(lbl, mask, connectivity)
        changed = bool((new != lbl).any())
        lbl = new
        if not changed:
            break
    return torch.where(mask, lbl + 1, torch.zeros((), dtype=torch.int32, device=mask.device))


def label_onehot(labels: torch.Tensor, max_labels: int) -> torch.Tensor:
    """(..., Y, X) labels -> (..., max_labels, Y, X) bool, label k at row
    k - 1 (the reference's ``transform_2d_to_3d`` with a static pad)."""
    ids = torch.arange(1, max_labels + 1, dtype=labels.dtype, device=labels.device)
    return labels.unsqueeze(-3) == ids.reshape(-1, 1, 1)


def segment_sum(values: torch.Tensor, labels: torch.Tensor, max_labels: int) -> torch.Tensor:
    """Per-label sums of each (B, ...) image -> (B, max_labels) f32, label k
    at column k - 1, through the sum kernel's wrapper
    (``extract.reductions.seg_sum``): exact for counts below 2^24."""
    from aliby_tpu_torch.extract.reductions import seg_sum

    B = labels.shape[0]
    return seg_sum(values.reshape(B, -1), labels.reshape(B, -1), max_labels)


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


def fill_label_holes_plain(labels: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`fill_label_holes` (the JAX package's
    stencil loop): component-wide (min, max) adjacent labels propagate by
    4-neighbour stencil rounds over the non-border-visible background
    until stable; the host checks for convergence every 8 rounds."""
    B, H, W = labels.shape
    dev = labels.device
    bg = labels == 0
    blocked = (~bg).to(torch.int32)
    vis = (
        (torch.cumsum(blocked, dim=1) == 0)
        | (torch.cumsum(blocked.flip(1), dim=1).flip(1) == 0)
        | (torch.cumsum(blocked, dim=2) == 0)
        | (torch.cumsum(blocked.flip(2), dim=2).flip(2) == 0)
    ) & bg
    rest = bg & ~vis
    big = torch.full((), _BIG, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    pmin = torch.full((B, H, W), _BIG, dtype=torch.int32, device=dev)
    pmax = torch.zeros((B, H, W), dtype=torch.int32, device=dev)
    four = ((-1, 0), (1, 0), (0, -1), (0, 1))
    for dy, dx in four:
        nb = shift(labels, dy, dx, 0)
        nvis = shift(vis, dy, dx, False)
        pmin = torch.minimum(pmin, torch.where(nb > 0, nb, big))
        pmax = torch.maximum(pmax, torch.where(nvis, big, nb))
    border = torch.zeros((H, W), dtype=torch.bool, device=dev)
    border[0, :] = True
    border[-1, :] = True
    border[:, 0] = True
    border[:, -1] = True
    pmax = torch.where(border, big, pmax)
    pmin = torch.where(rest, pmin, big)
    pmax = torch.where(rest, pmax, zero)
    nrest = [shift(rest, dy, dx, False) for dy, dx in four]

    def one_round(pmin, pmax):
        nmin, nmax = pmin, pmax
        for (dy, dx), nr in zip(four, nrest):
            nmin = torch.minimum(nmin, torch.where(nr, shift(pmin, dy, dx, _BIG), big))
            nmax = torch.maximum(nmax, torch.where(nr, shift(pmax, dy, dx, 0), zero))
        return torch.where(rest, nmin, big), torch.where(rest, nmax, zero)

    for _ in range(H * W):
        nmin, nmax = pmin, pmax
        for _ in range(8):
            nmin, nmax = one_round(nmin, nmax)
        changed = bool(((nmin != pmin) | (nmax != pmax)).any())
        pmin, pmax = nmin, nmax
        if not changed:
            break
    fillable = rest & (pmin == pmax) & (pmin > 0) & (pmax < _BIG)
    return torch.where(fillable, pmin, labels)


def fill_label_holes(labels: torch.Tensor) -> torch.Tensor:
    """Fill enclosed background holes per mask: a 4-connected background
    component that does not touch the border and borders exactly one label
    takes that label. (B, H, W) int32 -> (B, H, W) int32.

    A CPU tensor takes :func:`fill_label_holes_plain`. A CUDA tensor, which
    must be contiguous, launches ``kernels/csrc/holes.cu``: union-find
    labelling of the background that is not straight-line visible from the
    border, in :data:`FILL_LAUNCHES` launches and no host synchronisation,
    with the plain version's bits. It replaces no TPU kernel (the JAX
    package loops over stencil rounds); it exists because that loop took
    ~230 host-checked rounds of 26 launches a (18, 1080, 1080) call on the
    card, most of the flow-error QC's time, where the kernel is bound by
    the bytes of a few passes over the labels."""
    if labels.device.type == "cpu":
        return fill_label_holes_plain(labels)
    if labels.device.type != "cuda":
        raise ValueError(f"unsupported device {labels.device}")
    if labels.dim() != 3:
        raise ValueError(f"labels must be (B, H, W), got {tuple(labels.shape)}")
    if labels.dtype != torch.int32:
        raise TypeError(f"labels must be torch.int32, got {labels.dtype}")
    if not labels.is_contiguous():
        raise ValueError("labels must be contiguous")
    B, H, W = labels.shape
    if H * W >= 2**31 or B > 65535:
        raise ValueError(f"the kernel takes H * W < 2^31 and B <= 65535, got {(B, H, W)}")
    if labels.numel() == 0:
        return labels.clone()
    lib = _build.load("holes")
    out = torch.empty_like(labels)
    bounds = torch.empty(2 * B * (H + W), dtype=torch.int32, device=labels.device)
    maps = torch.empty(3 * labels.numel(), dtype=torch.int32, device=labels.device)
    with _build.on_device(labels):
        _build.check(
            lib.fill_label_holes(labels.data_ptr(), out.data_ptr(), bounds.data_ptr(),
                                 maps.data_ptr(), B, H, W, _build.stream_of(labels)),
            "fill_label_holes",
        )
    _build.count(fill_label_holes, FILL_LAUNCHES)
    return out


fill_label_holes.launches = 0


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
