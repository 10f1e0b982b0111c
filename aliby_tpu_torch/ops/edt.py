"""Euclidean distance transforms by jump flooding (counterpart of
``aliby_tpu/ops/edt.py``), batched over (B, H, W).

Every pixel carries the coordinates of its best seed so far (and, for the
label-aware modes, the seed's label) and, at strides halving from half the
image size down to 1 (after a stride-1 pre-pass, before a 2, 1 clean-up),
adopts better seeds from its 8 neighbours at that stride. A neighbour
outside the image reads the nearest edge pixel (the reference's edge
padding). Distances are compared as exact f32 squared integer distances,
so the result is bit-equal to the reference.

- :func:`edt`: seeds are the False pixels (scipy semantics);
- :func:`edt_to_other_label`: distance to the nearest pixel of a different
  label, background included (a per-object EDT that stays right when
  objects touch);
- :func:`edt_to_seed_same_label`: distance to the nearest same-label seed.
"""

from __future__ import annotations

import torch

from aliby_tpu_torch.ops.imageops import _sqrt

_FAR = -(2**20)


def _strides(h: int, w: int) -> list[int]:
    # 1 + JFA + 2: a stride-1 pre-pass, halving strides, then 2, 1 clean-up
    s = max(h, w) // 2
    out = [1]
    while s >= 1:
        out.append(s)
        s //= 2
    out.extend([2, 1])
    return out


def _edge_index(n: int, shift: int, device) -> torch.Tensor:
    return (torch.arange(n, device=device) + shift).clamp(0, n - 1)


def _dist2(state: torch.Tensor, ok) -> torch.Tensor:
    """Squared distance of each pixel to its state's seed (+inf where
    ``ok`` rejects the seed)."""
    _, B, H, W = state.shape
    yy = torch.arange(H, dtype=torch.int32, device=state.device).reshape(1, H, 1)
    xx = torch.arange(W, dtype=torch.int32, device=state.device).reshape(1, 1, W)
    dy = (yy - state[0]).to(torch.float32)
    dx = (xx - state[1]).to(torch.float32)
    return torch.where(ok(state), dy * dy + dx * dx,
                       torch.full((), float("inf"), device=state.device))


def _flood(state: torch.Tensor, ok) -> torch.Tensor:
    """Run the stride schedule on a (C, B, H, W) int32 state whose rows 0
    and 1 are the seed's (y, x); ``ok(cand)`` says which candidates are
    valid seeds for each pixel. Returns the final state."""
    _, B, H, W = state.shape
    dev = state.device
    for stride in _strides(H, W):
        best = _dist2(state, ok)
        new_state = state
        for sdy in (-1, 0, 1):
            rows = state.index_select(2, _edge_index(H, sdy * stride, dev))
            for sdx in (-1, 0, 1):
                if sdy == 0 and sdx == 0:
                    continue
                cand = rows.index_select(3, _edge_index(W, sdx * stride, dev))
                d = _dist2(cand, ok)
                take = d < best
                best = torch.where(take, d, best)
                new_state = torch.where(take, cand, new_state)
        state = new_state
    return state


def _jfa(seed_mask: torch.Tensor, labels: torch.Tensor | None, mode: str) -> torch.Tensor:
    """Squared distance to the nearest valid seed per pixel: mode "any"
    (any seed), "diff" (seed label != pixel label), "same" (==)."""
    B, H, W = seed_mask.shape
    dev = seed_mask.device
    yy = torch.arange(H, dtype=torch.int32, device=dev).reshape(1, H, 1).expand(B, H, W)
    xx = torch.arange(W, dtype=torch.int32, device=dev).reshape(1, 1, W).expand(B, H, W)
    far = torch.full((), _FAR, dtype=torch.int32, device=dev)
    rows = [torch.where(seed_mask, yy, far), torch.where(seed_mask, xx, far)]
    with_labels = mode != "any" and labels is not None
    if with_labels:
        labels = labels.to(torch.int32)
        rows.append(torch.where(seed_mask, labels, torch.zeros((), dtype=torch.int32, device=dev)))

    def ok(cand):
        has = cand[0] > _FAR
        if not with_labels:
            return has
        if mode == "diff":
            return has & (cand[2] != labels)
        return has & (cand[2] == labels)

    return _dist2(_flood(torch.stack(rows), ok), ok)


def nearest_seed(seed_mask: torch.Tensor):
    """Coordinates (sy, sx) of the nearest seed pixel for every pixel."""
    B, H, W = seed_mask.shape
    dev = seed_mask.device
    yy = torch.arange(H, dtype=torch.int32, device=dev).reshape(1, H, 1).expand(B, H, W)
    xx = torch.arange(W, dtype=torch.int32, device=dev).reshape(1, 1, W).expand(B, H, W)
    far = torch.full((), _FAR, dtype=torch.int32, device=dev)
    state = torch.stack([torch.where(seed_mask, yy, far), torch.where(seed_mask, xx, far)])
    final = _flood(state, lambda cand: cand[0] > _FAR)
    return final[0], final[1]


def _sqrt_finite(d2: torch.Tensor) -> torch.Tensor:
    return _sqrt(torch.where(torch.isfinite(d2), d2, torch.zeros((), device=d2.device)))


def edt(mask: torch.Tensor) -> torch.Tensor:
    """scipy.ndimage.distance_transform_edt per image: distance of True
    pixels to the nearest False pixel (False pixels -> 0)."""
    d = _sqrt_finite(_jfa(~mask, None, "any"))
    return torch.where(mask, d, torch.zeros((), device=d.device))


def edt_to_other_label(labels: torch.Tensor) -> torch.Tensor:
    """Distance from each foreground pixel to the nearest pixel whose label
    differs (background included); background pixels -> 0."""
    fg = labels > 0
    d = _sqrt_finite(_jfa(torch.ones_like(fg), labels, "diff"))
    return torch.where(fg, d, torch.zeros((), device=d.device))


def edt_to_seed_same_label(seed_mask: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Distance to the nearest same-label seed; pixels with no reachable
    seed get +inf (callers mask)."""
    return _sqrt(_jfa(seed_mask, labels, "same"))
