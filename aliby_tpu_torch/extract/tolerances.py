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
  * the Hu moments 2 to 6 (``AreaShape_HuMoment_k``), polynomials of the
    normalised moments of order 2 and 3 whose terms cancel (a near-symmetric
    object gives 1e-15 from terms of 1e-11): their polynomial with every
    moment by its absolute value and every difference made a sum, from the
    reference's ``AreaShape_NormalizedMoment_*`` (a one-cell 64^2 field
    read 1.78942e-15 against 1.78945e-15, 1.3e-3 of this atol);
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

The model zoo (``models/cpnet.py``, ``models/embedder.py``,
``models/spots.py``), held with :func:`within_model_tolerance`:

- the CPnet forward, f32, against the JAX package on the CPU or the card
  against the CPU: atol ``CPNET_ATOL`` of the output's largest |value|
  (the bound of ``tests/test_cpnet_port.py``, there on outputs of scale
  ~1); the style vector (unit norm) atol ``CPNET_ATOL``;
- cpnet labels, spot coordinates and labels, wire frames and tracks
  columns are exact;
- the CPnet forward in bf16: the U-Net's bf16 flow rule, max |diff| <=
  ``BF16_MAX_SHARE`` and mean |diff| <= ``BF16_MEAN_SHARE`` of the
  largest |value| (the two frameworks round to bf16 at other points);
- embeddings (the flagship U-Net's style vector, unit norm, projected): in
  f32 atol ``EMBED_F32_ATOL`` (the U-Net's f32 style bound in
  ``tests/test_torch_unet.py``); in bf16 (the default) max |diff| <=
  ``EMBED_BF16_ATOL`` (the U-Net's bf16 style bound there) and mean
  |diff| <= ``EMBED_BF16_MEAN_ATOL``. Sound readings reach max 9.3e-4,
  mean 9.3e-5 (example 02 on ``cellpainting_zarr``, port vs JAX); a 3%
  error in the channel mix reads max 1.6e-3 to 2.5e-3, mean 6.4e-4 to
  7.5e-4, and is caught by the mean.

Training (``models/training.py``), f32, held with :func:`gradient_excess`:

- the loss within rtol ``LOSS_RTOL``; each gradient tensor within
  ``GRAD_RTOL`` (port vs JAX on the CPU) or ``GRAD_CARD_RTOL`` (the card,
  TF32 off, vs the CPU) of its largest |value|. A tensor whose largest
  |value| is under ``GRAD_FLOOR`` of the model's largest has a gradient of
  0 but for rounding (a conv bias that a GroupNorm of one channel a group
  removes): there the limit is ``GRAD_FLOOR_ATOL`` (``GRAD_CARD_FLOOR_ATOL``)
  of the model's largest |value|. CPU readings against JAX: loss 8.3e-6,
  gradients 1.4e-5 of the tensor's largest, rounding-only tensors 1.8e-7
  of the model's largest (``tests/test_torch_training.py``).
- the parameters after a few steps whose gradients were summed in another
  order (the sharded step against one process, or against the JAX
  package's sharded step), held with :func:`update_excess`: per tensor,
  the L2 norm of the difference of the updates ``p - p_0`` within
  ``UPDATE_RTOL`` of the L2 norm of the reference's update. Adam divides
  each element's gradient by its own magnitude, so an element whose
  gradient is near Adam's eps (1e-8) turns a gradient error of 1e-5 of
  the tensor's largest into an update error of a good share of lr (the
  elementwise difference reaches 3,000 times 1e-4 of the largest update
  at the flagship widths); the norm weighs such elements by their share.
  A tensor whose gradient is rounding only (see above) takes Adam steps on
  noise, in either direction: there |p - p_ref| <= 2 sum_s lr_s. CPU
  readings (4 gloo ranks): widths (8, 16, 32), 2 steps, 1.3e-5 against
  one process and 4.6e-5 against JAX (the port's one-process step reads
  4.6e-5 against JAX too); the flagship widths, 8 x 128^2, one step,
  5.1e-4, its first gradient within 0.047 of ``GRAD_RTOL``
  (``tests/test_torch_sharded_training.py``, ``chip_smoke.py`` phase 10).
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
CPNET_ATOL = 2e-4
EMBED_F32_ATOL = 1e-5
EMBED_BF16_ATOL = 2e-3
EMBED_BF16_MEAN_ATOL = 2e-4
BF16_MAX_SHARE = 0.05
BF16_MEAN_SHARE = 0.005
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-4
GRAD_CARD_RTOL = 1e-3
GRAD_FLOOR = 1e-4
GRAD_FLOOR_ATOL = 1e-6
GRAD_CARD_FLOOR_ATOL = 1e-5
UPDATE_RTOL = 1e-2
_FIRST_MOMENTS = frozenset(f"AreaShape_{kind}Moment_{i}_{j}"
                           for kind in ("Central", "Normalized") for i, j in ((0, 1), (1, 0)))


_HU_CANCELLING = frozenset(f"AreaShape_HuMoment_{k}" for k in range(2, 7))


def _hu_terms(k: int, ref: Callable[[str], np.ndarray]) -> np.ndarray:
    """The magnitude of the terms of ``AreaShape_HuMoment_k`` (k = 2..6,
    ``extract/features.py`` ``sizeshape``): its polynomial in the normalised
    moments, each by its absolute value, with every difference a sum."""
    e = {(i, j): np.abs(ref(f"AreaShape_NormalizedMoment_{i}_{j}"))
         for i, j in ((2, 0), (0, 2), (1, 1), (3, 0), (0, 3), (2, 1), (1, 2))}
    p, q = e[3, 0] + e[1, 2], e[2, 1] + e[0, 3]
    u, v = e[3, 0] + 3 * e[1, 2], 3 * e[2, 1] + e[0, 3]
    return {2: u * u + v * v,
            3: p * p + q * q,
            4: u * p * (p * p + 3 * q * q) + v * q * (3 * p * p + q * q),
            5: (e[2, 0] + e[0, 2]) * (p * p + q * q) + 4 * e[1, 1] * p * q,
            6: v * p * (p * p + 3 * q * q) + u * q * (3 * p * p + q * q)}[k]


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
    if feat in _HU_CANCELLING:
        return rtol, 1e-6 * np.nan_to_num(_hu_terms(int(feat.rsplit("_", 1)[1]), ref))
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


def within_model_tolerance(got: np.ndarray, want: np.ndarray, rule: str) -> bool:
    """``rule``: ``"cpnet"`` (atol ``CPNET_ATOL`` of max(1, the largest
    |want|)), ``"f32"`` (atol ``EMBED_F32_ATOL``), ``"bf16"`` (the U-Net's
    bf16 shares of the largest |want|) or ``"embed"`` (bf16 embeddings:
    max ``EMBED_BF16_ATOL``, mean ``EMBED_BF16_MEAN_ATOL``)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return False
    diff = np.abs(got - want)
    if rule == "cpnet":
        return bool(diff.max(initial=0.0) <= CPNET_ATOL * max(1.0, _largest(want)))
    if rule == "f32":
        return bool(diff.max(initial=0.0) <= EMBED_F32_ATOL)
    if rule == "bf16":
        scale = _largest(want)
        return bool(diff.max(initial=0.0) <= BF16_MAX_SHARE * scale
                    and diff.mean() <= BF16_MEAN_SHARE * scale)
    if rule == "embed":
        return bool(diff.max(initial=0.0) <= EMBED_BF16_ATOL
                    and diff.mean() <= EMBED_BF16_MEAN_ATOL)
    raise ValueError(f"unknown rule {rule!r}")


def gradient_excess(got: dict, want: dict, rtol: float = GRAD_RTOL,
                    floor_atol: float = GRAD_FLOOR_ATOL) -> dict[str, tuple[float, bool]]:
    """Per gradient tensor (``name -> array``, the same names), the largest
    |got - want| over its limit, and whether the tensor is rounding only:
    the limit is ``rtol`` times the tensor's largest |want|, or, under
    ``GRAD_FLOOR`` of the model's largest |want|, ``floor_atol`` times the
    model's largest. A ratio above 1 is beyond the tolerance."""
    if set(got) != set(want):
        raise ValueError(f"gradient names differ: {sorted(set(got) ^ set(want))[:4]}")
    want = {k: np.asarray(v, np.float64) for k, v in want.items()}
    g_max = max(float(np.abs(v).max(initial=0.0)) for v in want.values())
    out = {}
    for name, w in want.items():
        scale = float(np.abs(w).max(initial=0.0))
        floor = scale < GRAD_FLOOR * g_max
        limit = floor_atol * g_max if floor else rtol * scale
        err = float(np.abs(np.asarray(got[name], np.float64) - w).max(initial=0.0))
        out[name] = (err / limit if limit > 0 else (0.0 if err == 0 else float("inf")), floor)
    return out


def update_excess(got: dict, want: dict, initial: dict, lr_sum: float,
                  rtol: float = UPDATE_RTOL, noise: frozenset = frozenset()
                  ) -> dict[str, float]:
    """Per parameter tensor after steps from ``initial``, the L2 norm of
    ``got - want`` over ``rtol`` times the L2 norm of ``want - initial``;
    for the tensors named in ``noise`` (gradients of rounding only) the
    largest |got - want| over ``2 * lr_sum``. A ratio above 1 is beyond
    the tolerance."""
    if set(got) != set(want) or set(got) != set(initial):
        raise ValueError("parameter names differ")
    out = {}
    for name in want:
        g, w, p0 = (np.asarray(t[name], np.float64) for t in (got, want, initial))
        if name in noise:
            out[name] = float(np.abs(g - w).max(initial=0.0)) / (2 * lr_sum)
            continue
        err, scale = float(np.linalg.norm(g - w)), float(np.linalg.norm(w - p0))
        out[name] = err / (rtol * scale) if scale > 0 else (0.0 if err == 0 else float("inf"))
    return out
