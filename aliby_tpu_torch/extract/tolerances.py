"""The tolerances at which the port's feature values are held to a
reference: the JAX package on the CPU (``tests/test_torch_features.py``,
``tests/test_torch_fused.py``) and the port on the CPU against the card
(``chip_smoke.py``). numpy only.

- Integer-valued features (areas, bounding boxes, convex area, Euler
  number, spatial moments, the max-intensity location) are exact.
- pearson and slope: rtol 1e-4 (a covariance formed as a difference of
  f32 means); every other feature rtol 1e-5.
- atol is 1e-6 of the feature's largest |value|, except where a value is
  formed by cancellation; there it is 1e-6 of the magnitude of the terms
  that cancel, per object:

  * the first central moments sum_p (x_p - cx) (0 up to rounding): the
    object's area times its largest centred coordinate |x - cx| or
    |y - cy| (from its bounding box and centre); the first normalised
    moments, the same over area * sqrt(area);
  * the mass displacement |intensity centroid - centroid|: the centroid's
    coordinates, |x| + |y|;
  * the standard deviations sqrt(E[x^2] - mean^2): a near-constant object
    cancels to the ulp of mean^2, so atol is 1e-5 of the largest mean.

- The Haralick features (``Texture_*``): the reference takes each
  (angle, label) group's totals as differences of one f32 running sum over
  all 4 H W pair slots of the image, whose error grows with the running
  total (up to ~eps log2(N) times it) and not with the group's own; the
  port's running sum is float64. Against the reference a feature is held
  to atol 5e-5 of its largest |value| (measured: up to 8.4e-6, the inverse
  difference moment, on 96x96 and 128x128 fields). The variances subtract
  a squared mean from a second moment, so there atol is 1e-4 of the terms
  that cancel, per object: SumAverage^2 for SumVariance and Variance
  (measured 2.4e-5 and 4.5e-6), and that over the Variance for the
  Correlation, a ratio of two such differences.
- The zernike magnitudes (``Zernike_n_m``, ``RadialZernike_n_m``) are
  |sum_p w_p R_nm(rho_p) e^{i m theta_p}| (n + 1) / (pi r^2), near 0 for a
  symmetric object: atol is 2e-6 of (n + 1) times the object's (0, 0)
  moment, the magnitude of the terms (|R_nm| <= 1; cos and sin of
  m theta <= 9 pi carry an absolute rounding error of ~2e-6 a term;
  measured 4e-7).
- costes and costes_2 decide a threshold (the stop-k of the descending
  scan, the sign of a correlation near 0): one ulp in the Deming slope can
  move it, so at most ``THRESHOLD_SHARE`` of the object values (at least
  one) may differ there, and nowhere else.

- The cellfuns metrics (``extract/cellfuns.py``): ``area`` is exact; the
  others are held as the default bank is, and ``std`` as the standard
  deviations above (atol 1e-5 of the largest ``mean`` of the same
  objects, where the tree holds one).
- The localisation metrics (``nuc_est_conv``, ``small_peaks_conv``) are
  maxima of FFT correlations, whose f32 rounding differs between FFT
  libraries (XLA's, pocketfft, cuFFT), absolutely in proportion to the
  image's largest values: rtol ``LOCALISATION_RTOL`` and atol
  ``LOCALISATION_ATOL_SHARE`` of the largest |value| (measured against the
  JAX package: 5.8e-7 of it on ``tests/test_torch_cellfuns.py``'s fields,
  where cells with a flat image give values near 1e-8).

NaN positions (absent labels) must be equal everywhere.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

INTEGER_VALUED = frozenset({
    "area", "AreaShape_Area", "AreaShape_BoundingBoxArea", "AreaShape_ConvexArea",
    "AreaShape_EulerNumber", "AreaShape_MaximumRadius",
    "Location_MaxIntensity_X", "Location_MaxIntensity_Y",
    *(f"AreaShape_BoundingBox{m}_{a}" for m in ("Maximum", "Minimum") for a in "XY"),
    *(f"AreaShape_SpatialMoment_{i}_{j}" for i in range(3) for j in range(4)),
})
THRESHOLD_DECIDED = frozenset({"costes", "costes_2"})
LOCALISATION_METRICS = ("nuc_est_conv", "small_peaks_conv")
LOCALISATION_RTOL = 1e-4
LOCALISATION_ATOL_SHARE = 1e-5
THRESHOLD_SHARE = 0.05
_FIRST_MOMENTS = frozenset(f"AreaShape_{kind}Moment_{i}_{j}"
                           for kind in ("Central", "Normalized") for i, j in ((0, 1), (1, 0)))


def _largest(values: np.ndarray) -> float:
    ok = ~np.isnan(values)
    return float(np.abs(values[ok]).max()) if ok.any() else 0.0


def _largest_centred_coordinate(ref: Callable[[str], np.ndarray]) -> np.ndarray:
    w = 0.0
    for a in "XY":
        c = ref(f"AreaShape_Center_{a}")
        w = np.maximum(w, np.maximum(ref(f"AreaShape_BoundingBoxMaximum_{a}") - c,
                                     c - ref(f"AreaShape_BoundingBoxMinimum_{a}")))
    return w


def tolerance(feat: str, ref: Callable[[str], np.ndarray]):
    """(rtol, atol) of feature ``feat``; ``ref(name)`` gives the reference
    values of another feature of the same objects. atol is a scalar or one
    value per object."""
    if feat in INTEGER_VALUED:
        return 0.0, 0.0
    if feat in THRESHOLD_DECIDED:
        return 1e-5, 1e-6
    rtol = 1e-4 if feat in ("pearson", "slope") else 1e-5
    if feat in _FIRST_MOMENTS:
        area = ref("AreaShape_Area")
        terms = area * _largest_centred_coordinate(ref)
        if "Normalized" in feat:
            terms = terms / (area * np.sqrt(area))
        return rtol, 1e-6 * np.nan_to_num(terms)
    if feat == "Intensity_MassDisplacement":
        terms = (np.abs(ref("Location_CenterMassIntensity_X"))
                 + np.abs(ref("Location_CenterMassIntensity_Y")))
        return rtol, 1e-6 * np.nan_to_num(terms)
    if feat.startswith("Texture_"):
        name = feat.split("_")[1]
        if name in ("SumVariance", "Variance", "Correlation"):
            terms = ref(feat.replace(name, "SumAverage")) ** 2
            if name == "Correlation":
                terms = terms / np.maximum(ref(feat.replace(name, "Variance")), 1e-6)
            return rtol, 1e-4 * np.nan_to_num(terms)
        return rtol, 5e-5 * _largest(ref(feat))
    if feat.startswith(("Zernike_", "RadialZernike_")):
        family, n, _m = feat.split("_")
        return rtol, 2e-6 * (int(n) + 1) * np.nan_to_num(np.abs(ref(f"{family}_0_0")))
    if feat.startswith("Intensity_StdIntensity"):
        return rtol, 1e-5 * _largest(ref(feat.replace("Std", "Mean")))
    if feat == "std":
        return rtol, 1e-5 * _largest(ref("mean"))
    if feat in LOCALISATION_METRICS:
        return LOCALISATION_RTOL, LOCALISATION_ATOL_SHARE * _largest(ref(feat))
    return rtol, 1e-6 * _largest(ref(feat))


def beyond_tolerance(feat: str, got: np.ndarray, want: np.ndarray,
                     ref: Callable[[str], np.ndarray]) -> np.ndarray:
    """Mask of the values of ``got`` that differ from ``want`` beyond the
    tolerance of ``feat``; a NaN against a number is beyond, two NaNs and
    two equal infinities are not."""
    rtol, atol = tolerance(feat, ref)
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    nan_g, nan_w = np.isnan(got), np.isnan(want)
    with np.errstate(invalid="ignore"):
        close = (got == want) | (np.abs(got - want) <= atol + rtol * np.abs(want))
    return (nan_g != nan_w) | (~nan_g & ~close)
