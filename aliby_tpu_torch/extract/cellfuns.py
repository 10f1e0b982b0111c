"""The reference's hand-written per-cell metrics, for every label of a batch
of tiles at once (counterpart of ``aliby_tpu/extract/cellfuns.py``).

Reference: ``extraction/core/functions/cell.py:18-303`` (scalar functions
applied one object at a time) and ``functions/trap.py:6-43`` (tile-level
background metrics). Labels are ``(B, H, W)`` and a per-label result is
``(B, max_labels)``, label k at column k - 1. The reference's quirks are
kept: 1-indexed centroids, axes rounded from chained distance transforms,
NaN for ``max5px_median`` on cells of 5 pixels or fewer.

Per-label sums, min/max and per-pixel broadcasts of per-label values run
through ``extract.reductions`` (the sum, min/max and lookup kernels on the
card).
"""

from __future__ import annotations

import math

import torch

from aliby_tpu_torch.extract.reductions import (
    _div,
    _ipow,
    _label_index,
    _sort_keys,
    counts,
    quantile_from_sorted,
    seg_max,
    seg_sum_cols,
    sorted_by_label,
    table_lookup,
    topk_mean_from_sorted,
)
from aliby_tpu_torch.ops.edt import edt_to_other_label, edt_to_seed_same_label
from aliby_tpu_torch.ops.imageops import _sqrt

MASK_METRICS = ("area", "eccentricity", "volume", "conical_volume",
                "spherical_volume", "centroid_x", "centroid_y")
PIXEL_METRICS = ("mean", "total", "total_squared", "median", "max2p5pc",
                 "max5px_median", "std", "moment_of_inertia")
TRAP_METRICS = ("imBackground", "background_max5")

_NEG_INF = float("-inf")


def _nan(like: torch.Tensor) -> torch.Tensor:
    return torch.full((), float("nan"), device=like.device)


def _nan_absent(v: torch.Tensor, present: torch.Tensor) -> torch.Tensor:
    return torch.where(present, v, _nan(v))


def _per_pixel(table: torch.Tensor, labels: torch.Tensor, max_labels: int) -> torch.Tensor:
    """(B, L, K) per-label values -> (B, H, W, K) at each pixel's label
    (label 0 reads label 1's row; callers mask the background)."""
    return table_lookup(table, _label_index(labels, max_labels))


def _coords1(labels: torch.Tensor):
    """1-indexed (row, column) coordinates of each pixel, (B, H, W) f32."""
    B, H, W = labels.shape
    yy = torch.arange(1, H + 1, dtype=torch.float32, device=labels.device).reshape(1, H, 1)
    xx = torch.arange(1, W + 1, dtype=torch.float32, device=labels.device).reshape(1, 1, W)
    return yy.expand(B, H, W), xx.expand(B, H, W)


def _min_maj(labels: torch.Tensor, nn: torch.Tensor, max_labels: int):
    """Per-label (min_axis, maj_axis, sum of the cone top) by the
    reference's cone construction: nn = EDT to outside the object (min
    axis = round(max nn)); dn = EDT to the plateau argmax(nn); the cone top
    is the EDT from the plateau to the nearest non-plateau pixel; maj axis =
    round(max dn + sum(cone top) / 2)."""
    fg = labels > 0
    neg_inf = torch.full((), _NEG_INF, device=labels.device)
    zero = torch.zeros((), device=labels.device)
    max_nn = seg_max(torch.where(fg, nn, neg_inf), labels, max_labels)
    max_nn_px = _per_pixel(torch.nan_to_num(max_nn).unsqueeze(-1), labels, max_labels)[..., 0]
    plateau = fg & (nn >= max_nn_px - 1e-6)
    dn = edt_to_seed_same_label(plateau, labels)
    dn = torch.where(fg & torch.isfinite(dn), dn, zero)
    cone_top = edt_to_seed_same_label(fg & ~plateau, labels)
    cone_top = torch.where(plateau & torch.isfinite(cone_top), cone_top, zero)
    min_ax = torch.round(torch.nan_to_num(max_nn, neginf=0.0))
    return min_ax, seg_max(torch.where(fg, dn, neg_inf), labels, max_labels), cone_top


def min_maj_approximation(labels: torch.Tensor, max_labels: int):
    """Per-label (min_axis, maj_axis) of (B, H, W) labels."""
    nn = edt_to_other_label(labels)
    min_ax, max_dn, cone_top = _min_maj(labels, nn, max_labels)
    cone = seg_sum_cols(cone_top.unsqueeze(-1), labels, max_labels)[..., 0]
    return min_ax, torch.round(max_dn.clamp_min(0) + _div(cone, 2.0))


def mask_metrics(labels: torch.Tensor, max_labels: int) -> dict:
    """area, eccentricity, volumes and centroids of every label, one pass."""
    nn = edt_to_other_label(labels)
    min_ax, max_dn, cone_top = _min_maj(labels, nn, max_labels)
    yy, xx = _coords1(labels)
    ones = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    acc = seg_sum_cols(torch.stack([ones, cone_top, nn, xx, yy], dim=-1), labels, max_labels)
    area = acc[..., 0]
    maj_ax = torch.round(max_dn.clamp_min(0) + _div(acc[..., 1], 2.0))
    present = area > 0
    safe = area.clamp_min(1.0)
    ecc = _div(_sqrt((maj_ax * maj_ax - min_ax * min_ax).clamp_min(0.0)), maj_ax.clamp_min(1e-12))
    four_pi = torch.tensor(4 * math.pi, dtype=torch.float32, device=labels.device)
    volume = _div(four_pi * (min_ax * min_ax) * maj_ax, 3.0)
    r = _sqrt(_div(area, math.pi))
    out = {
        "area": area,
        "eccentricity": ecc,
        "volume": volume,
        "conical_volume": 4 * acc[..., 2],
        "spherical_volume": _div(four_pi * _ipow(r, 3), 3.0),
        "centroid_x": acc[..., 3] / safe,
        "centroid_y": acc[..., 4] / safe,
    }
    return {k: _nan_absent(v, present) for k, v in out.items()}


def pixel_metrics(labels: torch.Tensor, img: torch.Tensor, max_labels: int) -> dict:
    """mean, total, total_squared, median, max2p5pc, max5px_median, std and
    moment_of_inertia of every label over (B, H, W) ``img``."""
    img = img.to(torch.float32)
    area = counts(labels, max_labels)
    present = area > 0
    safe = area.clamp_min(1.0)
    yy, xx = _coords1(labels)
    acc = seg_sum_cols(torch.stack([img, img * img, img * xx, img * yy], dim=-1), labels,
                       max_labels)
    total, total_sq = acc[..., 0], acc[..., 1]
    mean = total / safe
    # E[x^2] - mean^2 with one rounding, as XLA contracts it into an FMA
    # (mean^2 is exact in float64, and so is the difference)
    var = (((total_sq / safe).to(torch.float64) - mean.to(torch.float64) ** 2)
           .to(torch.float32).clamp_min(0.0))
    sv, starts, cnt = sorted_by_label(img, labels, max_labels)
    median = quantile_from_sorted(sv, starts, cnt, 0.5)
    max2p5pc = topk_mean_from_sorted(sv, starts, cnt, 0.025)
    # max5px_median: mean of the 5 brightest / median; NaN at <= 5 px or a 0 median
    end = starts + cnt.to(torch.int32)
    last = sv.shape[1] - 1
    five_sum = None
    for k in range(1, 6):
        v = torch.gather(sv, 1, (end - k).clamp(0, last).to(torch.int64))
        five_sum = v if five_sum is None else five_sum + v
    max5 = _div(five_sum, 5.0)
    max5px_median = torch.where((cnt > 5) & (median.abs() > 0), max5 / median, _nan(median))
    # moment of inertia (1-indexed, intensity-weighted; cell.py:222-261)
    nonzero = total.abs() > 1e-12
    safe_m = torch.where(nonzero, total, torch.ones((), device=total.device))
    centre = torch.stack([acc[..., 2] / safe_m, acc[..., 3] / safe_m], dim=-1)
    c_px = _per_pixel(centre, labels, max_labels)
    dx = xx - c_px[..., 0]
    dy = yy - c_px[..., 1]
    mu = seg_sum_cols(torch.stack([img * (dx * dx), img * (dy * dy)], dim=-1), labels, max_labels)
    moi = (mu[..., 0] + mu[..., 1]) / (safe_m * safe_m)
    out = {
        "mean": mean,
        "total": total,
        "total_squared": total_sq,
        "median": median,
        "max2p5pc": max2p5pc,
        "max5px_median": max5px_median,
        "std": _sqrt(var),
        "moment_of_inertia": torch.where(nonzero, moi, _nan(moi)),
    }
    return {k: _nan_absent(v, present) for k, v in out.items()}


def background_metrics(labels: torch.Tensor, img: torch.Tensor) -> dict:
    """Tile-level background statistics (reference ``trap.py``): the median
    and the mean of the 5 brightest background pixels of each tile, (B,)."""
    B = labels.shape[0]
    flat_bg = (labels == 0).reshape(B, -1)
    flat_v = img.to(torch.float32).reshape(B, -1)
    n_bg = flat_bg.sum(dim=1)
    # background first, each part ascending (lax.sort on (key, value))
    _, order = torch.sort(_sort_keys((~flat_bg).to(torch.int32), flat_v), dim=1, stable=True)
    sv = torch.gather(flat_v, 1, order)
    pos = _div((n_bg - 1).to(torch.float32), 2.0)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.ceil(pos).to(torch.int64)
    frac = pos - lo
    last = sv.shape[1] - 1
    v_lo = torch.gather(sv, 1, lo.clamp(0, last).unsqueeze(1))[:, 0]
    v_hi = torch.gather(sv, 1, hi.clamp(0, last).unsqueeze(1))[:, 0]
    med = v_lo * (1 - frac) + v_hi * frac
    top = torch.where(flat_bg, flat_v, torch.full((), _NEG_INF, device=flat_v.device))
    k = min(5, top.shape[1])
    vals = torch.topk(top, k, dim=1).values
    five = vals[:, 0]
    for i in range(1, k):
        five = five + vals[:, i]
    bmax5 = torch.where(n_bg >= 5, _div(five, float(k)), _nan(five))
    return {"imBackground": torch.where(n_bg > 0, med, _nan(med)), "background_max5": bmax5}
