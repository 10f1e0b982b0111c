"""The cp_measure-class feature bank (counterpart of
``aliby_tpu/extract/features.py``).

Each family computes the whole family for all labels of a batch of images
at once: ``(B, H, W)`` labels (and ``(B, H, W)`` images) ->
``{CellProfiler_feature_name: (B, max_labels)}``, where the reference maps
one image with ``jax.vmap``. Absent labels carry NaN. The per-label
reductions are ``extract/reductions.py``; the plain scatters of the
reference (intensity's first argmax, the rwc rank scatter, label row
extents) stay plain PyTorch scatters that give the same bits on every run,
and the costes histogram runs through the deterministic
``binned_sum_cols_batched``.
"""

from __future__ import annotations

import math

import torch

from aliby_tpu_torch.extract.reductions import (
    LabelStats,
    _div,
    _ipow,
    _label_index,
    _run_starts,
    _shifted,
    _sort_keys,
    boundary_mask,
    convex_area_pixels,
    counts,
    directional_extents,
    ellipse_params,
    feret_diameters,
    mad_from_sorted,
    quantile_from_sorted,
    seg_max,
    seg_min,
    seg_minmax_cols,
    seg_sum,
    seg_sum_cols,
    sorted_by_label,
    table_lookup,
)
from aliby_tpu_torch.ops.edt import edt_to_other_label
from aliby_tpu_torch.ops.imageops import _sqrt
from aliby_tpu_torch.ops.segsum import binned_sum_cols_batched

_SQRT2 = math.sqrt(2.0)
_PI = math.pi


def _nanpad(values: torch.Tensor, present: torch.Tensor) -> torch.Tensor:
    return torch.where(present, values, torch.full((), float("nan"), device=values.device))


def _zero(t: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=t.dtype, device=t.device)


# ---------------------------------------------------------------------------
# sizeshape (CellProfiler MeasureObjectSizeShape / AreaShape_*)
# ---------------------------------------------------------------------------


def _perimeter(labels: torch.Tensor, max_labels: int) -> torch.Tensor:
    """skimage-style weighted perimeter per label: border pixels weighted
    by their same-label 4/8-neighbour border counts with the
    Vossepoel-Smeulders coefficients of ``skimage.measure.perimeter``."""
    border = boundary_mask(labels)  # 4-connected: skimage's default erosion
    b = border.to(torch.float32)
    l_pad = torch.nn.functional.pad(labels, (1, 1, 1, 1))
    b_pad = torch.nn.functional.pad(b, (1, 1, 1, 1))
    n4 = torch.zeros_like(b)
    nd = torch.zeros_like(b)
    for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        n4 = n4 + _shifted(b_pad, dy, dx) * (_shifted(l_pad, dy, dx) == labels)
    for dy, dx in ((-1, -1), (-1, 1), (1, -1), (1, 1)):
        nd = nd + _shifted(b_pad, dy, dx) * (_shifted(l_pad, dy, dx) == labels)
    code = (10 * nd + 2 * n4 + 1) * b  # pattern code = 10*diag + 2*orth + centre
    w = torch.zeros_like(code)
    one_codes = (5, 7, 15, 17, 25, 27)
    sqrt2_codes = (21, 33)
    mixed_codes = (13, 23)
    for c in one_codes:
        w = w + (code == c) * 1.0
    for c in sqrt2_codes:
        w = w + (code == c) * _SQRT2
    for c in mixed_codes:
        w = w + (code == c) * ((1 + _SQRT2) / 2)
    # any other border pattern counts as unit length
    known = torch.zeros_like(code, dtype=torch.bool)
    for c in one_codes + sqrt2_codes + mixed_codes:
        known = known | (code == c)
    w = w + (~known & border) * 1.0
    return seg_sum(w, labels, max_labels)


def _euler_number(labels: torch.Tensor, max_labels: int) -> torch.Tensor:
    """Euler number per label (8-connectivity) via bit-quad counts."""
    pad = torch.nn.functional.pad(labels, (1, 0, 1, 0))
    a = pad[:, :-1, :-1]
    b = pad[:, :-1, 1:]
    c = pad[:, 1:, :-1]
    d = pad[:, 1:, 1:]
    quad_lbl = torch.maximum(torch.maximum(a, b), torch.maximum(c, d))
    fa, fb, fc, fd = (x > 0 for x in (a, b, c, d))
    n_set = fa.to(torch.int32) + fb + fc + fd
    q1 = (n_set == 1).to(torch.float32)
    q3 = (n_set == 3).to(torch.float32)
    qd = ((n_set == 2) & ((fa & fd & ~fb & ~fc) | (fb & fc & ~fa & ~fd))).to(torch.float32)
    contrib = _div(q1 - q3 - 2.0 * qd, 4.0)
    return seg_sum(contrib, quad_lbl, max_labels)


def _moment_products(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B, H, W) coordinates -> (B, H, W, 16) products y^i x^j, column 4i+j."""
    ypow = [_ipow(y, i) for i in range(4)]
    xpow = [_ipow(x, j) for j in range(4)]
    return torch.stack([ypow[i] * xpow[j] for i in range(4) for j in range(4)], dim=-1)


def sizeshape(labels: torch.Tensor, max_labels: int) -> dict:
    st = LabelStats(labels, max_labels)
    present = st.present
    area = st.area
    mu20, mu02, mu11 = st.central_moments()
    major, minor, ecc, orientation = ellipse_params(mu20, mu02, mu11, area)
    bb_mn, bb_mx = seg_minmax_cols(torch.stack([st.yy, st.xx], dim=-1), labels, max_labels)
    min_y, min_x = bb_mn[..., 0], bb_mn[..., 1]
    max_y, max_x = bb_mx[..., 0], bb_mx[..., 1]
    bbox_area = (max_y - min_y + 1) * (max_x - min_x + 1)
    perimeter = _perimeter(labels, max_labels)
    pmax, pmin = directional_extents(labels, max_labels, n_dir=360)
    max_feret, min_feret = feret_diameters(pmax, pmin)
    # hull rasterisation at every other direction (180 slabs)
    convex_area = convex_area_pixels(labels, max_labels, pmax=pmax[..., ::2],
                                     pmin=pmin[..., ::2], n_dir=180)
    convex_area = torch.maximum(convex_area, area)  # the hull can't be smaller
    fg = labels > 0
    dist = torch.where(fg, edt_to_other_label(labels), torch.zeros((), device=labels.device))
    max_radius = seg_max(dist, labels, max_labels)
    mean_radius = seg_sum(dist, labels, max_labels) / st.safe_area
    sv_d, starts_d, cnt_d = sorted_by_label(dist, labels, max_labels)
    median_radius = torch.nan_to_num(quantile_from_sorted(sv_d, starts_d, cnt_d, 0.5))
    euler = _euler_number(labels, max_labels)
    form_factor = 4 * _PI * area / (perimeter * perimeter).clamp_min(1e-12)
    p = perimeter.clamp_min(0.0)
    compactness = p * p / (4 * _PI * area).clamp_min(1e-12)
    out = {
        "AreaShape_Area": area,
        "AreaShape_BoundingBoxArea": bbox_area,
        "AreaShape_BoundingBoxMaximum_X": max_x,
        "AreaShape_BoundingBoxMaximum_Y": max_y,
        "AreaShape_BoundingBoxMinimum_X": min_x,
        "AreaShape_BoundingBoxMinimum_Y": min_y,
        "AreaShape_Center_X": st.cx,
        "AreaShape_Center_Y": st.cy,
        "AreaShape_Compactness": compactness,
        "AreaShape_ConvexArea": convex_area,
        "AreaShape_Eccentricity": ecc,
        "AreaShape_EquivalentDiameter": _sqrt(_div(4 * area, _PI)),
        "AreaShape_EulerNumber": euler,
        "AreaShape_Extent": area / bbox_area.clamp_min(1.0),
        "AreaShape_FormFactor": form_factor,
        "AreaShape_MajorAxisLength": major,
        "AreaShape_MaxFeretDiameter": max_feret,
        "AreaShape_MaximumRadius": max_radius,
        "AreaShape_MeanRadius": mean_radius,
        "AreaShape_MedianRadius": median_radius,
        "AreaShape_MinFeretDiameter": min_feret,
        "AreaShape_MinorAxisLength": minor,
        "AreaShape_Orientation": _div(orientation * 180.0, _PI),
        "AreaShape_Perimeter": perimeter,
        "AreaShape_Solidity": area / convex_area.clamp_min(1.0),
    }
    # spatial / central / normalised moments, Hu moments, inertia tensor
    # (CellProfiler's 2-D grid); all 16 y^i x^j products in one 16-column
    # sum (17 with the non-finite indicator)
    acc = seg_sum_cols(_moment_products(st.yy, st.xx), labels, max_labels)
    for i in range(3):
        for j in range(4):
            out[f"AreaShape_SpatialMoment_{i}_{j}"] = acc[..., i * 4 + j]
    # central moments accumulate centred, sqrt(area)-scaled coordinates
    # (the binomial expansion cancels in f32 far from the origin):
    # with s = sqrt(area), mu_ij = acc_ij * s^(i+j) and eta_ij = acc_ij / s^2
    s_lbl = _sqrt(st.safe_area)
    dyn, dxn = st.centered_scaled_coords()
    acc_c = seg_sum_cols(_moment_products(dyn, dxn), labels, max_labels)
    mu = {}
    eta = {}
    for i in range(4):
        for j in range(4):
            mu[(i, j)] = acc_c[..., i * 4 + j] * _ipow(s_lbl, i + j)
            if i <= 2:
                out[f"AreaShape_CentralMoment_{i}_{j}"] = mu[(i, j)]
    for i in range(4):
        for j in range(4):
            eta[(i, j)] = acc_c[..., i * 4 + j] / st.safe_area
            out[f"AreaShape_NormalizedMoment_{i}_{j}"] = eta[(i, j)]
    e = eta
    sq = lambda t: t * t  # noqa: E731
    hu0 = e[(2, 0)] + e[(0, 2)]
    hu1 = sq(e[(2, 0)] - e[(0, 2)]) + 4 * sq(e[(1, 1)])
    hu2 = sq(e[(3, 0)] - 3 * e[(1, 2)]) + sq(3 * e[(2, 1)] - e[(0, 3)])
    hu3 = sq(e[(3, 0)] + e[(1, 2)]) + sq(e[(2, 1)] + e[(0, 3)])
    hu4 = (e[(3, 0)] - 3 * e[(1, 2)]) * (e[(3, 0)] + e[(1, 2)]) * (
        sq(e[(3, 0)] + e[(1, 2)]) - 3 * sq(e[(2, 1)] + e[(0, 3)])
    ) + (3 * e[(2, 1)] - e[(0, 3)]) * (e[(2, 1)] + e[(0, 3)]) * (
        3 * sq(e[(3, 0)] + e[(1, 2)]) - sq(e[(2, 1)] + e[(0, 3)])
    )
    hu5 = (e[(2, 0)] - e[(0, 2)]) * (
        sq(e[(3, 0)] + e[(1, 2)]) - sq(e[(2, 1)] + e[(0, 3)])
    ) + 4 * e[(1, 1)] * (e[(3, 0)] + e[(1, 2)]) * (e[(2, 1)] + e[(0, 3)])
    hu6 = (3 * e[(2, 1)] - e[(0, 3)]) * (e[(3, 0)] + e[(1, 2)]) * (
        sq(e[(3, 0)] + e[(1, 2)]) - 3 * sq(e[(2, 1)] + e[(0, 3)])
    ) - (e[(3, 0)] - 3 * e[(1, 2)]) * (e[(2, 1)] + e[(0, 3)]) * (
        3 * sq(e[(3, 0)] + e[(1, 2)]) - sq(e[(2, 1)] + e[(0, 3)])
    )
    for idx, h in enumerate((hu0, hu1, hu2, hu3, hu4, hu5, hu6)):
        out[f"AreaShape_HuMoment_{idx}"] = h
    # inertia tensor [[mu20, -mu11], [-mu11, mu02]] / mu00, eigenvalues descending
    t00 = mu[(2, 0)] / st.safe_area
    t01 = -mu[(1, 1)] / st.safe_area
    t11 = mu[(0, 2)] / st.safe_area
    out["AreaShape_InertiaTensor_0_0"] = t00
    out["AreaShape_InertiaTensor_0_1"] = t01
    out["AreaShape_InertiaTensor_1_0"] = t01
    out["AreaShape_InertiaTensor_1_1"] = t11
    half_tr = _div(t00 + t11, 2.0)
    disc = _sqrt((sq(_div(t00 - t11, 2.0)) + sq(t01)).clamp_min(0.0))
    out["AreaShape_InertiaTensorEigenvalues_0"] = half_tr + disc
    out["AreaShape_InertiaTensorEigenvalues_1"] = half_tr - disc
    return {k: _nanpad(v, present) for k, v in out.items()}


def feret(labels: torch.Tensor, max_labels: int) -> dict:
    """The ``feret`` family: Feret diameters over 64 directions."""
    pmax, pmin = directional_extents(labels, max_labels)
    mx, mn = feret_diameters(pmax, pmin)
    return {"MaxFeretDiameter": mx, "MinFeretDiameter": mn}


# ---------------------------------------------------------------------------
# intensity (CellProfiler MeasureObjectIntensity / Intensity_*)
# ---------------------------------------------------------------------------


def intensity(labels: torch.Tensor, img: torch.Tensor, max_labels: int,
              edge_measurements: bool = True) -> dict:
    img = img.to(torch.float32)
    st = LabelStats(labels, max_labels)
    present = st.present
    # one 4-column sum: total, squares, y- and x-weighted
    acc_i = seg_sum_cols(torch.stack([img, img * img, st.yy * img, st.xx * img], dim=-1),
                         labels, max_labels)
    total = acc_i[..., 0]
    mean = total / st.safe_area
    sq = acc_i[..., 1]
    std = _sqrt((sq / st.safe_area - mean * mean).clamp_min(0.0))
    mn, mx = seg_minmax_cols(img.unsqueeze(-1), labels, max_labels)
    vmin, vmax = mn[..., 0], mx[..., 0]
    sv, starts, cnt = sorted_by_label(img, labels, max_labels)
    median = quantile_from_sorted(sv, starts, cnt, 0.5)
    q1 = quantile_from_sorted(sv, starts, cnt, 0.25)
    q3 = quantile_from_sorted(sv, starts, cnt, 0.75)
    l_idx = _label_index(labels, max_labels)
    lk = table_lookup(torch.nan_to_num(vmax, neginf=0.0).unsqueeze(-1), l_idx)
    mad = mad_from_sorted(sv, starts, cnt, median)
    # intensity-weighted centroid and mass displacement
    safe_total = total.clamp_min(1e-12)
    wcy = acc_i[..., 2] / safe_total
    wcx = acc_i[..., 3] / safe_total
    dcy, dcx = wcy - st.cy, wcx - st.cx
    mass_disp = _sqrt(dcy * dcy + dcx * dcx)
    # the max-intensity pixel: the first one in scan order among tied maxima
    B, H, W = labels.shape
    flat_l = labels.reshape(B, -1).to(torch.int64)
    flat_v = img.reshape(B, -1)
    pos = torch.arange(H * W, dtype=torch.float32, device=img.device).expand(B, -1)
    is_best = (flat_v == lk[..., 0].reshape(B, -1)) & (flat_l > 0)
    inf = torch.full((), float("inf"), device=img.device)
    best_px = torch.full((B, max_labels + 2), float("inf"), device=img.device)
    best_idx = torch.where(is_best, flat_l.clamp_max(max_labels + 1), 0)  # spare column past L
    best_px.scatter_reduce_(1, best_idx, torch.where(is_best, pos, inf), "amin")
    best_px = best_px[:, 1:-1]
    best_px = torch.where(torch.isfinite(best_px), best_px, _zero(best_px))
    max_y = torch.floor(_div(best_px, float(W)))
    max_x = best_px - max_y * W
    out = {
        "Intensity_IntegratedIntensity": total,
        "Intensity_MeanIntensity": mean,
        "Intensity_StdIntensity": std,
        "Intensity_MinIntensity": vmin,
        "Intensity_MaxIntensity": vmax,
        "Intensity_MedianIntensity": median,
        "Intensity_MADIntensity": mad,
        "Intensity_LowerQuartileIntensity": q1,
        "Intensity_UpperQuartileIntensity": q3,
        "Intensity_MassDisplacement": mass_disp,
        "Location_CenterMassIntensity_X": wcx,
        "Location_CenterMassIntensity_Y": wcy,
        "Location_CenterMassIntensity_Z": torch.zeros_like(wcx),
        "Location_MaxIntensity_X": max_x,
        "Location_MaxIntensity_Y": max_y,
        "Location_MaxIntensity_Z": torch.zeros_like(max_x),
    }
    if edge_measurements:
        edge = boundary_mask(labels)
        e_labels = torch.where(edge, labels, _zero(labels))
        e_cnt = counts(e_labels, max_labels)
        e_total = seg_sum(img, e_labels, max_labels)
        e_mean = e_total / e_cnt.clamp_min(1.0)
        e_sq = seg_sum(img * img, e_labels, max_labels)
        e_std = _sqrt((e_sq / e_cnt.clamp_min(1.0) - e_mean * e_mean).clamp_min(0.0))
        out.update({
            "Intensity_IntegratedIntensityEdge": e_total,
            "Intensity_MeanIntensityEdge": e_mean,
            "Intensity_StdIntensityEdge": e_std,
            "Intensity_MinIntensityEdge": seg_min(torch.where(edge, img, inf), labels,
                                                  max_labels),
            "Intensity_MaxIntensityEdge": seg_max(torch.where(edge, img, -inf), labels,
                                                  max_labels),
        })
    return {k: _nanpad(v, present) for k, v in out.items()}


# ---------------------------------------------------------------------------
# Correlation / colocalisation (two channels, one mask)
# ---------------------------------------------------------------------------


def _per_label_pearson(labels, im1, im2, max_labels, weights=None):
    w = torch.ones_like(im1) if weights is None else weights
    inside = (labels > 0).to(torch.float32) * w
    acc = seg_sum_cols(torch.stack([inside, im1 * inside, im2 * inside, im1 * im1 * inside,
                                    im2 * im2 * inside, im1 * im2 * inside], dim=-1),
                       labels, max_labels)  # the six correlation sums in one pass
    n, s1, s2, s11, s22, s12 = (acc[..., i] for i in range(6))
    safe_n = n.clamp_min(1.0)
    m1, m2 = s1 / safe_n, s2 / safe_n
    cov = s12 / safe_n - m1 * m2
    v1 = (s11 / safe_n - m1 * m1).clamp_min(0.0)
    v2 = (s22 / safe_n - m2 * m2).clamp_min(0.0)
    denom = _sqrt(v1 * v2)
    corr = (cov / denom.clamp_min(1e-12)) * (denom > 1e-12)
    slope = (cov / v1.clamp_min(1e-12)) * (v1 > 1e-12)
    return corr, slope, n


def pearson(labels, im1, im2, max_labels) -> dict:
    im1 = im1.to(torch.float32)
    im2 = im2.to(torch.float32)
    corr, slope, n = _per_label_pearson(labels, im1, im2, max_labels)
    present = n > 0
    return {"pearson": _nanpad(corr, present), "slope": _nanpad(slope, present)}


def manders_fold(labels, im1, im2, max_labels, thr_frac: float = 0.15) -> dict:
    """Manders coefficients against a fraction-of-per-label-max threshold."""
    im1 = im1.to(torch.float32)
    im2 = im2.to(torch.float32)
    present = counts(labels, max_labels) > 0
    _, seg_mx = seg_minmax_cols(torch.stack([im1, im2], dim=-1), labels, max_labels)
    t = torch.nan_to_num(seg_mx) * thr_frac
    lk = table_lookup(t, _label_index(labels, max_labels))
    fg = labels > 0
    above2 = fg & (im2 > lk[..., 1])
    above1 = fg & (im1 > lk[..., 0])
    z = _zero(im1)
    sums = seg_sum_cols(torch.stack([torch.where(fg, im1, z), torch.where(fg, im2, z),
                                     torch.where(above2, im1, z), torch.where(above1, im2, z)],
                                    dim=-1), labels, max_labels)
    m1 = sums[..., 2] / sums[..., 0].clamp_min(1e-12)
    m2 = sums[..., 3] / sums[..., 1].clamp_min(1e-12)
    return {"manders_fold": _nanpad(m1, present), "manders_fold_2": _nanpad(m2, present)}


def rwc(labels, im1, im2, max_labels, thr_frac: float = 0.15) -> dict:
    """Rank-weighted colocalisation (Singan et al.), per label. Per-label
    intensity ranks come from one stable sort of (label, value) per image
    and channel, ties in pixel order; ranks scatter back to the pixels."""
    im1 = im1.to(torch.float32)
    im2 = im2.to(torch.float32)
    cnt = counts(labels, max_labels)
    present = cnt > 0
    B = labels.shape[0]
    flat_l = labels.reshape(B, 1, -1)
    N = flat_l.shape[-1]
    flat_v = torch.stack([im1.reshape(B, -1), im2.reshape(B, -1)], dim=1)  # (B, 2, N)
    _, sid = torch.sort(_sort_keys(flat_l.expand(B, 2, N), flat_v), dim=-1, stable=True)
    positions = torch.arange(N, dtype=torch.float32, device=im1.device).expand(B, 2, N)
    rank_px = torch.empty(B, 2, N, dtype=torch.float32, device=im1.device)
    rank_px.scatter_(2, sid, positions)  # a permutation: every slot written once
    starts = _run_starts(cnt, N)
    start_px = table_lookup(starts.unsqueeze(-1), _label_index(flat_l[:, 0], max_labels))[..., 0]
    r1 = (rank_px[:, 0] - start_px).reshape(labels.shape)
    r2 = (rank_px[:, 1] - start_px).reshape(labels.shape)
    _, seg_mx = seg_minmax_cols(torch.stack([im1, im2], dim=-1), labels, max_labels)
    mmax = torch.nan_to_num(seg_mx)
    lk = table_lookup(torch.stack([(cnt - 1.0).clamp_min(1.0), mmax[..., 0] * thr_frac,
                                   mmax[..., 1] * thr_frac], dim=-1),
                      _label_index(labels, max_labels))
    rmax, t1_px, t2_px = lk[..., 0], lk[..., 1], lk[..., 2]
    weight = (rmax - torch.abs(r1 - r2)) / rmax
    fg = labels > 0
    coloc = fg & (im1 > t1_px) & (im2 > t2_px)
    z = _zero(im1)
    sums = seg_sum_cols(torch.stack([torch.where(fg, im1, z), torch.where(fg, im2, z),
                                     torch.where(coloc, im1 * weight, z),
                                     torch.where(coloc, im2 * weight, z)], dim=-1),
                        labels, max_labels)
    rwc1 = sums[..., 2] / sums[..., 0].clamp_min(1e-12)
    rwc2 = sums[..., 3] / sums[..., 1].clamp_min(1e-12)
    return {"rwc": _nanpad(rwc1, present), "rwc_2": _nanpad(rwc2, present)}


def _six_stats(im1: torch.Tensor, im2: torch.Tensor) -> torch.Tensor:
    return torch.stack([torch.ones_like(im1), im1, im2, im1 * im1, im2 * im2, im1 * im2], dim=-1)


def costes(labels, im1, im2, max_labels, scale_max: int = 255) -> dict:
    """Costes colocalisation, CellProfiler ``linear_costes`` semantics
    (``features.costes``): a Deming regression of im2 on im1, then the
    descending threshold scan evaluated for every k at once from a
    histogram over m = min(bin1, bin2) on the candidate grids, stop-k = the
    largest k with non-positive correlation below the thresholds.

    The threshold step ``max(im1) / scale_max`` is an IEEE division here
    (XLA:CPU multiplies by the rounded reciprocal); the histogram sums run
    through the deterministic ``binned_sum_cols_batched``.
    """
    im1 = im1.to(torch.float32)
    im2 = im2.to(torch.float32)
    cnt = counts(labels, max_labels)
    present = cnt > 0
    fg = labels > 0
    l_idx = _label_index(labels, max_labels)
    z = _zero(im1)
    # Deming regression over (im1>0)|(im2>0) pixels, ddof=1
    nz = fg & ((im1 > 0) | (im2 > 0))
    reg = seg_sum_cols(torch.where(nz.unsqueeze(-1), _six_stats(im1, im2), z),
                       torch.where(nz, labels, _zero(labels)), max_labels)
    n_r, s1_r, s2_r, s11_r, s22_r, s12_r = (reg[..., i] for i in range(6))
    nm1 = (n_r - 1.0).clamp_min(1.0)
    mx = s1_r / n_r.clamp_min(1.0)
    my = s2_r / n_r.clamp_min(1.0)
    vx = ((s11_r - n_r * mx * mx) / nm1).clamp_min(0.0)
    vy = ((s22_r - n_r * my * my) / nm1).clamp_min(0.0)
    cov = (s12_r - n_r * mx * my) / nm1
    safe_cov = torch.where(torch.abs(cov) > 1e-20, cov, torch.ones((), device=cov.device))
    dv = vy - vx
    a = (dv + _sqrt(dv * dv + 4.0 * (cov * cov))) / (2.0 * safe_cov)
    b = my - a * mx
    reg_ok = (n_r >= 2) & (torch.abs(cov) > 1e-20) & (a > 0)
    # exact-grid histogram over m = min(bin1, bin2)
    m1max = torch.nan_to_num(seg_minmax_cols(im1.unsqueeze(-1), labels, max_labels)[1][..., 0])
    i_step = _div(m1max.clamp_min(1e-20), float(scale_max))
    nb = scale_max + 2
    safe_a = torch.where(reg_ok, a, torch.ones((), device=a.device))
    lk_g = table_lookup(torch.stack([i_step, b, safe_a], dim=-1), l_idx)
    step_px, b_px, a_px = lk_g[..., 0], lk_g[..., 1], lk_g[..., 2]
    bin1 = torch.floor(im1 / step_px).clamp(0, nb - 1).to(torch.int32)
    bin2 = torch.floor((im2 - b_px) / (a_px * step_px)).clamp(0, nb - 1).to(torch.int32)
    m_bin = torch.minimum(bin1, bin2)
    B = labels.shape[0]
    flat_bin = (torch.where(fg, labels, _zero(labels)) * nb + m_bin).reshape(B, -1)
    stats = torch.where(fg.reshape(B, -1, 1), _six_stats(im1, im2).reshape(B, -1, 6), z)
    h = binned_sum_cols_batched(stats, flat_bin, (max_labels + 1) * nb)
    h = h.reshape(B, max_labels + 1, nb, 6)[:, 1:]
    above6 = torch.flip(torch.cumsum(torch.flip(h, dims=[2]), dim=2), dims=[2])  # (B, L, nb, 6)
    tot = above6[:, :, 0:1, :]  # the suffix at 0: all the label's pixels
    below = tot - above6
    n_b, s1_b, s2_b, s11_b, s22_b, s12_b = (below[..., i] for i in range(6))
    safe_n = n_b.clamp_min(1.0)
    m1b, m2b = s1_b / safe_n, s2_b / safe_n
    cov_b = s12_b / safe_n - m1b * m2b
    v1_b = (s11_b / safe_n - m1b * m1b).clamp_min(0.0)
    v2_b = (s22_b / safe_n - m2b * m2b).clamp_min(0.0)
    corr = cov_b / _sqrt(v1_b * v2_b).clamp_min(1e-20)
    ok = (n_b >= 2) & (v1_b > 0) & (v2_b > 0) & (corr <= 0.0)
    ks = torch.arange(nb, device=corr.device, dtype=torch.int32)
    # the scan tests k = scale_max-1 .. 1; the first (largest) non-positive k wins
    ok = ok & (ks >= 1) & (ks <= scale_max - 1)
    k_star = torch.where(ok, ks, 0).amax(dim=-1).clamp_min(1)
    t1 = k_star.to(torch.float32) * i_step
    t2 = a * t1 + b
    lk_t = table_lookup(torch.stack([t1, t2], dim=-1), l_idx)
    above1 = fg & (im1 > lk_t[..., 0])
    above2 = fg & (im2 > lk_t[..., 1])
    both = above1 & above2
    sums4 = seg_sum_cols(torch.stack([torch.where(above1, im1, z), torch.where(above2, im2, z),
                                      torch.where(both, im1, z), torch.where(both, im2, z)],
                                     dim=-1), labels, max_labels)
    den1, den2 = sums4[..., 0], sums4[..., 1]
    c1 = sums4[..., 2] / den1.clamp_min(1e-20)
    c2 = sums4[..., 3] / den2.clamp_min(1e-20)
    good = present & reg_ok & (den1 > 0) & (den2 > 0)
    return {"costes": _nanpad(c1, good), "costes_2": _nanpad(c2, good)}


CORRELATION_FEATURES = {
    "pearson": pearson,
    "manders_fold": manders_fold,
    "rwc": rwc,
    "costes": costes,
}
