"""Nuclear-localisation estimates (counterpart of
``aliby_tpu/extract/localisation.py``), for every label of a batch of tiles.

Reference (``extraction/core/functions/custom/localisation.py:16-140``):
``nuc_est_conv`` convolves each cell's median-subtracted, mask-zeroed image
with a Gaussian whose sigma derives from the cell's area and reports the
normalised convolution maximum; ``small_peaks_conv`` does the same with a
disk sized to the expected nucleus. Per-cell kernel sizes are quantised
onto the reference's geometric grid of 7 buckets: one FFT correlation per
bucket over the tiles restricted to that bucket's cells, each label's
maximum taken from its own bucket.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from aliby_tpu_torch.extract.reductions import (
    _div,
    _label_index,
    counts,
    quantile_from_sorted,
    seg_max,
    sorted_by_label,
    table_lookup,
)
from aliby_tpu_torch.ops.imageops import _sqrt, fft_correlate_same

CHI2INV_95_DF2 = 5.991464547107979  # scipy.stats.chi2.ppf(0.95, 2)
_SIGMA_BUCKETS = (0.75, 1.2, 1.9, 3.0, 4.8, 7.6, 12.0)
LOCALISATION_METRICS = ("nuc_est_conv", "small_peaks_conv")


def _gauss2d(size: int, sigma: float) -> np.ndarray:
    """MATLAB ``fspecial('gaussian')``-style normalised kernel (f32)."""
    f32 = np.float32
    y = np.arange(size, dtype=f32) - f32((size - 1) / 2.0)
    h = np.exp(-(y[:, None] ** 2 + y[None, :] ** 2) / f32(2.0 * sigma ** 2)).astype(f32)
    h = np.where(h < np.finfo(f32).eps * h.max(), f32(0.0), h).astype(f32)
    return (h / max(h.sum(dtype=f32), f32(1e-12))).astype(f32)


def _disk(radius: float, size: int) -> np.ndarray:
    y = np.arange(size, dtype=np.float32) - np.float32((size - 1) / 2.0)
    return ((y[:, None] ** 2 + y[None, :] ** 2) <= np.float32(radius ** 2)).astype(np.float32)


def _bucket_of(x: torch.Tensor) -> torch.Tensor:
    """Index of the nearest bucket in log space (the first on a tie)."""
    logb = torch.log(torch.tensor(_SIGMA_BUCKETS, dtype=torch.float32, device=x.device))
    d = (torch.log(x.clamp_min(1e-3)).unsqueeze(-1) - logb).abs()
    is_min = d == d.amin(dim=-1, keepdim=True)
    idx = torch.arange(len(_SIGMA_BUCKETS), device=x.device).expand_as(d)
    return torch.where(is_min, idx, len(_SIGMA_BUCKETS)).amin(dim=-1)


def _bucket_px(bucket: torch.Tensor, labels: torch.Tensor, max_labels: int) -> torch.Tensor:
    """Each pixel's label's bucket, (B, H, W) int."""
    table = bucket.to(torch.float32).unsqueeze(-1)
    return table_lookup(table, _label_index(labels, max_labels))[..., 0].to(torch.int64)


def _kernel(k: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(k).to(device)


def nuc_est_conv(labels: torch.Tensor, img: torch.Tensor, max_labels: int,
                 alpha: float = 0.95, object_radius_estimation: float = 0.085) -> torch.Tensor:
    img = img.to(torch.float32)
    fg = labels > 0
    zero = torch.zeros((), device=img.device)
    neg_inf = torch.full((), float("-inf"), device=img.device)
    sv, starts, cnt = sorted_by_label(torch.where(fg, img, zero), labels, max_labels)
    median = torch.nan_to_num(quantile_from_sorted(sv, starts, cnt, 0.5))
    nonzero = counts(torch.where(fg & (img != 0), labels, torch.zeros_like(labels)), max_labels)
    r = _sqrt(_div(object_radius_estimation * nonzero, math.pi))
    sigma = r / torch.sqrt(torch.tensor(CHI2INV_95_DF2, dtype=torch.float32, device=img.device))
    med_px = table_lookup(median.unsqueeze(-1), _label_index(labels, max_labels))[..., 0]
    cell_image = torch.where(fg, img - med_px, zero)
    bucket = _bucket_of(sigma)
    bucket_px = _bucket_px(bucket, labels, max_labels)
    out = torch.full(cnt.shape, float("nan"), device=img.device)
    for b, sig in enumerate(_SIGMA_BUCKETS):
        r_b = sig * math.sqrt(CHI2INV_95_DF2)
        kernel = _gauss2d(2 * int(math.ceil(2 * r_b)) + 1, sig)
        sel = fg & (bucket_px == b)
        conv = fft_correlate_same(torch.where(sel, cell_image, zero), _kernel(kernel, img.device))
        per_label_max = seg_max(torch.where(sel, conv, neg_inf), labels, max_labels)
        norm = np.float32(np.sum(kernel * kernel, dtype=np.float32))
        for f in (alpha, math.pi, CHI2INV_95_DF2, sig ** 2):
            norm = np.float32(norm * np.float32(f))
        val = _div(per_label_max, max(float(norm), 1e-12))
        out = torch.where((bucket == b) & (cnt > 0), val, out)
    return out


def small_peaks_conv(labels: torch.Tensor, img: torch.Tensor, max_labels: int) -> torch.Tensor:
    """Max of a disk-kernel convolution within each cell; disk radius
    3 * (0.025 * n_pixels) / 5, quantised to the buckets."""
    img = img.to(torch.float32)
    fg = labels > 0
    neg_inf = torch.full((), float("-inf"), device=img.device)
    area = counts(labels, max_labels)
    bucket = _bucket_of(_div(3.0 * (area * 0.025), 5.0))
    bucket_px = _bucket_px(bucket, labels, max_labels)
    out = torch.full(area.shape, float("nan"), device=img.device)
    for b, r_b in enumerate(_SIGMA_BUCKETS):
        kernel = _disk(r_b, 2 * int(math.ceil(r_b)) + 1)
        conv = fft_correlate_same(img, _kernel(kernel, img.device))
        per_label_max = seg_max(torch.where(fg & (bucket_px == b), conv, neg_inf), labels,
                                max_labels)
        out = torch.where((bucket == b) & (area > 0), per_label_max, out)
    return out


def compute(metric: str, labels: torch.Tensor, img: torch.Tensor, max_labels: int):
    """``metric`` of every label; a (B, Z, H, W) stack is max-projected."""
    if img.dim() == 4:
        img = img.amax(dim=1)
    if metric == "nuc_est_conv":
        return nuc_est_conv(labels, img, max_labels)
    if metric == "small_peaks_conv":
        return small_peaks_conv(labels, img, max_labels)
    raise KeyError(metric)
