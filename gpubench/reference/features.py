"""Per-object feature oracle (NumPy/SciPy): the benchmark's frozen copy.

Straightforward per-object scalar implementations of the published
CellProfiler/centrosome measurement definitions, written with numpy and
scipy (ConvexHull, EDT, ndimage), one object mask at a time: a code path
apart from the program's vectorised feature bank. The benchmark's output
check (``gpubench/check.py``) computes every family of a cell's bank with
it on a seeded sample of the objects that a run wrote, on the program's
masks and the benchmark's own pixels.

Conventions mirrored from the label-map bank are marked ``# convention``;
their upstream (cp_measure) counterpart may bin or normalise differently.
Kept as it was frozen, so that later changes to the program cannot move it.
"""

from __future__ import annotations

import math

import numpy as np
from scipy import ndimage
from scipy.spatial import ConvexHull

SQRT2 = math.sqrt(2.0)


# ---------------------------------------------------------------------------
# sizeshape
# ---------------------------------------------------------------------------


def _moments(mask: np.ndarray):
    ys, xs = np.nonzero(mask)
    m = {}
    for i in range(4):
        for j in range(4):
            m[(i, j)] = float(((ys.astype(np.float64) ** i) * (xs ** j)).sum())
    return m, ys, xs


def o_perimeter(mask: np.ndarray) -> float:
    """skimage.measure.perimeter algorithm: border pixels weighted by their
    4/8-neighborhood border pattern (Vossepoel–Smeulders)."""
    m = mask.astype(bool)
    eroded = ndimage.binary_erosion(
        m, structure=ndimage.generate_binary_structure(2, 1), border_value=0
    )
    border = m & ~eroded
    strel4 = np.array([[0, 1, 0], [1, 0, 1], [0, 1, 0]])
    streld = np.array([[1, 0, 1], [0, 0, 0], [1, 0, 1]])
    n4 = ndimage.convolve(border.astype(float), strel4, mode="constant")
    nd = ndimage.convolve(border.astype(float), streld, mode="constant")
    code = (10 * nd + 2 * n4 + 1) * border
    total = 0.0
    for c, w in [
        (5, 1.0), (7, 1.0), (15, 1.0), (17, 1.0), (25, 1.0), (27, 1.0),
        (21, SQRT2), (33, SQRT2),
        (13, (1 + SQRT2) / 2), (23, (1 + SQRT2) / 2),
    ]:
        total += w * float((code == c).sum())
    known = np.isin(code, [5, 7, 15, 17, 25, 27, 21, 33, 13, 23])
    total += float((border & ~known).sum())  # convention (unit weight rest)
    return total


def o_convex_area(mask: np.ndarray) -> float:
    """Pixel count of the convex image (skimage ``convex_image`` style)."""
    ys, xs = np.nonzero(mask)
    if len(ys) < 3:
        return float(len(ys))
    pts = np.stack([ys, xs], 1).astype(float)
    try:
        hull = ConvexHull(pts)
    except Exception:
        return float(len(ys))
    # count grid points inside (or on) the hull polygon
    from scipy.spatial import Delaunay

    tri = Delaunay(pts[hull.vertices])
    yy, xx = np.mgrid[ys.min(): ys.max() + 1, xs.min(): xs.max() + 1]
    grid = np.stack([yy.ravel(), xx.ravel()], 1).astype(float)
    inside = tri.find_simplex(grid) >= 0
    return float(inside.sum())


def o_convex_hull_polygon_area(mask: np.ndarray) -> float:
    """Exact hull polygon area of pixel centers (shoelace)."""
    ys, xs = np.nonzero(mask)
    if len(ys) < 3:
        return float(len(ys))
    pts = np.stack([ys, xs], 1).astype(float)
    try:
        return float(ConvexHull(pts).volume)
    except Exception:
        return float(len(ys))


def o_feret(mask: np.ndarray) -> tuple[float, float]:
    """(max, min) Feret diameters by rotating calipers over the hull of
    pixel centers, +1 px for pixel width (the JAX bank's convention)."""
    ys, xs = np.nonzero(mask)
    pts = np.stack([ys, xs], 1).astype(float)
    if len(pts) == 1:
        return 1.0, 1.0
    if len(pts) == 2:
        d = float(np.hypot(*(pts[0] - pts[1])))
        return d + 1.0, 1.0
    try:
        hull_pts = pts[ConvexHull(pts).vertices]
    except Exception:
        hull_pts = pts
    thetas = np.linspace(0, np.pi, 3600, endpoint=False)
    dirs = np.stack([np.cos(thetas), np.sin(thetas)], 1)
    proj = hull_pts @ dirs.T  # (P, K)
    widths = proj.max(0) - proj.min(0) + 1.0
    return float(widths.max()), float(widths.min())


def o_euler_number(mask: np.ndarray) -> float:
    """components(8-conn) - holes(4-conn)."""
    s8 = np.ones((3, 3))
    n_obj = ndimage.label(mask, structure=s8)[1]
    filled = np.pad(mask, 1)
    bg = ~filled.astype(bool)
    n_bg = ndimage.label(bg)[1]  # 4-connectivity default
    return float(n_obj - (n_bg - 1))


def o_sizeshape(mask: np.ndarray) -> dict:
    mask = mask.astype(bool)
    m, ys, xs = _moments(mask)
    area = m[(0, 0)]
    cy, cx = m[(1, 0)] / area, m[(0, 1)] / area
    mu = {}
    for i in range(4):
        for j in range(4):
            acc = 0.0
            for p in range(i + 1):
                for q in range(j + 1):
                    acc += (
                        math.comb(i, p) * math.comb(j, q)
                        * (-cy) ** (i - p) * (-cx) ** (j - q) * m[(p, q)]
                    )
            mu[(i, j)] = acc
    eta = {k: v / area ** (1.0 + (k[0] + k[1]) / 2.0) for k, v in mu.items()}
    # ellipse params from normalized second moments (regionprops formulas)
    u20, u02, u11 = mu[(2, 0)] / area, mu[(0, 2)] / area, mu[(1, 1)] / area
    common = math.sqrt(max((u20 - u02) ** 2 + 4 * u11 ** 2, 0.0))
    l1 = (u20 + u02 + common) / 2.0
    l2 = (u20 + u02 - common) / 2.0
    major = 4.0 * math.sqrt(max(l1, 0.0))
    minor = 4.0 * math.sqrt(max(l2, 0.0))
    ecc = math.sqrt(max(1.0 - l2 / l1, 0.0)) if l1 > 0 else 0.0
    # regionprops orientation convention (angle of major axis vs y-axis)
    orientation = 0.5 * math.atan2(-2 * u11, u02 - u20)
    perim = o_perimeter(mask)
    edt = ndimage.distance_transform_edt(mask)
    dists = edt[mask]
    convex_area = o_convex_area(mask)
    max_f, min_f = o_feret(mask)
    bbox_area = float(
        (ys.max() - ys.min() + 1) * (xs.max() - xs.min() + 1)
    )
    e = eta
    hu = [
        e[(2, 0)] + e[(0, 2)],
        (e[(2, 0)] - e[(0, 2)]) ** 2 + 4 * e[(1, 1)] ** 2,
        (e[(3, 0)] - 3 * e[(1, 2)]) ** 2 + (3 * e[(2, 1)] - e[(0, 3)]) ** 2,
        (e[(3, 0)] + e[(1, 2)]) ** 2 + (e[(2, 1)] + e[(0, 3)]) ** 2,
        (e[(3, 0)] - 3 * e[(1, 2)]) * (e[(3, 0)] + e[(1, 2)])
        * ((e[(3, 0)] + e[(1, 2)]) ** 2 - 3 * (e[(2, 1)] + e[(0, 3)]) ** 2)
        + (3 * e[(2, 1)] - e[(0, 3)]) * (e[(2, 1)] + e[(0, 3)])
        * (3 * (e[(3, 0)] + e[(1, 2)]) ** 2 - (e[(2, 1)] + e[(0, 3)]) ** 2),
        (e[(2, 0)] - e[(0, 2)])
        * ((e[(3, 0)] + e[(1, 2)]) ** 2 - (e[(2, 1)] + e[(0, 3)]) ** 2)
        + 4 * e[(1, 1)] * (e[(3, 0)] + e[(1, 2)]) * (e[(2, 1)] + e[(0, 3)]),
        (3 * e[(2, 1)] - e[(0, 3)]) * (e[(3, 0)] + e[(1, 2)])
        * ((e[(3, 0)] + e[(1, 2)]) ** 2 - 3 * (e[(2, 1)] + e[(0, 3)]) ** 2)
        - (e[(3, 0)] - 3 * e[(1, 2)]) * (e[(2, 1)] + e[(0, 3)])
        * (3 * (e[(3, 0)] + e[(1, 2)]) ** 2 - (e[(2, 1)] + e[(0, 3)]) ** 2),
    ]
    out = {
        "AreaShape_Area": area,
        "AreaShape_BoundingBoxArea": bbox_area,
        "AreaShape_BoundingBoxMaximum_X": float(xs.max()),
        "AreaShape_BoundingBoxMaximum_Y": float(ys.max()),
        "AreaShape_BoundingBoxMinimum_X": float(xs.min()),
        "AreaShape_BoundingBoxMinimum_Y": float(ys.min()),
        "AreaShape_Center_X": cx,
        "AreaShape_Center_Y": cy,
        "AreaShape_Compactness": perim ** 2 / (4 * math.pi * area),
        "AreaShape_ConvexArea": convex_area,
        "AreaShape_Eccentricity": ecc,
        "AreaShape_EquivalentDiameter": math.sqrt(4 * area / math.pi),
        "AreaShape_EulerNumber": o_euler_number(mask),
        "AreaShape_Extent": area / bbox_area,
        "AreaShape_FormFactor": 4 * math.pi * area / perim ** 2,
        "AreaShape_MajorAxisLength": major,
        "AreaShape_MaxFeretDiameter": max_f,
        "AreaShape_MaximumRadius": float(dists.max()),
        "AreaShape_MeanRadius": float(dists.mean()),
        "AreaShape_MedianRadius": float(np.quantile(dists, 0.5)),
        "AreaShape_MinFeretDiameter": min_f,
        "AreaShape_MinorAxisLength": minor,
        "AreaShape_Orientation": orientation * 180.0 / math.pi,
        "AreaShape_Perimeter": perim,
        "AreaShape_Solidity": area / convex_area,
    }
    # CellProfiler's exact 2-D advanced grid: Spatial/Central over i<=2,
    # j<=3; Normalized over (0..3)^2; Hu 0..6; inertia tensor + eigenvalues
    # (binary Zernike lives in the separate "zernike" feature upstream).
    for i in range(4):
        for j in range(4):
            if i <= 2:
                out[f"AreaShape_SpatialMoment_{i}_{j}"] = m[(i, j)]
                out[f"AreaShape_CentralMoment_{i}_{j}"] = mu[(i, j)]
            out[f"AreaShape_NormalizedMoment_{i}_{j}"] = eta[(i, j)]
    for idx, h in enumerate(hu):
        out[f"AreaShape_HuMoment_{idx}"] = h
    t00 = mu[(2, 0)] / area
    t01 = -mu[(1, 1)] / area
    t11 = mu[(0, 2)] / area
    out["AreaShape_InertiaTensor_0_0"] = t00
    out["AreaShape_InertiaTensor_0_1"] = t01
    out["AreaShape_InertiaTensor_1_0"] = t01
    out["AreaShape_InertiaTensor_1_1"] = t11
    half_tr = (t00 + t11) / 2.0
    disc = math.sqrt(max(((t00 - t11) / 2.0) ** 2 + t01**2, 0.0))
    out["AreaShape_InertiaTensorEigenvalues_0"] = half_tr + disc
    out["AreaShape_InertiaTensorEigenvalues_1"] = half_tr - disc
    return out


# ---------------------------------------------------------------------------
# intensity
# ---------------------------------------------------------------------------


def o_intensity(mask: np.ndarray, img: np.ndarray, edge_measurements=True) -> dict:
    mask = mask.astype(bool)
    v = img[mask].astype(np.float64)
    ys, xs = np.nonzero(mask)
    total = v.sum()
    med = float(np.quantile(v, 0.5))
    wcy = (ys * img[mask]).sum() / max(total, 1e-12)
    wcx = (xs * img[mask]).sum() / max(total, 1e-12)
    cy, cx = ys.mean(), xs.mean()
    k = int(np.argmax(v))
    out = {
        "Intensity_IntegratedIntensity": total,
        "Intensity_MeanIntensity": v.mean(),
        "Intensity_StdIntensity": v.std(),
        "Intensity_MinIntensity": v.min(),
        "Intensity_MaxIntensity": v.max(),
        "Intensity_MedianIntensity": med,
        "Intensity_MADIntensity": float(np.quantile(np.abs(v - med), 0.5)),
        "Intensity_LowerQuartileIntensity": float(np.quantile(v, 0.25)),
        "Intensity_UpperQuartileIntensity": float(np.quantile(v, 0.75)),
        "Intensity_MassDisplacement": math.hypot(wcy - cy, wcx - cx),
        "Location_CenterMassIntensity_X": wcx,
        "Location_CenterMassIntensity_Y": wcy,
        "Location_CenterMassIntensity_Z": 0.0,
        "Location_MaxIntensity_X": float(xs[k]),
        "Location_MaxIntensity_Y": float(ys[k]),
        "Location_MaxIntensity_Z": 0.0,
    }
    if edge_measurements:
        # CellProfiler/centrosome outline convention: 4-connected erosion
        eroded = ndimage.binary_erosion(
            mask, structure=ndimage.generate_binary_structure(2, 1),
            border_value=0,
        )
        edge = mask & ~eroded
        ev = img[edge].astype(np.float64)
        out.update(
            {
                "Intensity_IntegratedIntensityEdge": ev.sum(),
                "Intensity_MeanIntensityEdge": ev.mean(),
                "Intensity_StdIntensityEdge": ev.std(),
                "Intensity_MinIntensityEdge": ev.min(),
                "Intensity_MaxIntensityEdge": ev.max(),
            }
        )
    return out


# ---------------------------------------------------------------------------
# correlation
# ---------------------------------------------------------------------------


def o_pearson(mask, im1, im2) -> dict:
    a = im1[mask.astype(bool)].astype(np.float64)
    b = im2[mask.astype(bool)].astype(np.float64)
    va, vb = a.var(), b.var()
    cov = ((a - a.mean()) * (b - b.mean())).mean()
    corr = cov / math.sqrt(va * vb) if va > 0 and vb > 0 else 0.0
    slope = cov / va if va > 0 else 0.0
    return {"pearson": corr, "slope": slope}


def o_manders_fold(mask, im1, im2, thr_frac=0.15) -> dict:
    m = mask.astype(bool)
    a, b = im1[m].astype(np.float64), im2[m].astype(np.float64)
    t1, t2 = a.max() * thr_frac, b.max() * thr_frac
    m1 = a[b > t2].sum() / max(a.sum(), 1e-12)
    m2 = b[a > t1].sum() / max(b.sum(), 1e-12)
    return {"manders_fold": m1, "manders_fold_2": m2}


def o_rwc(mask, im1, im2, thr_frac=0.15) -> dict:
    m = mask.astype(bool)
    a, b = im1[m].astype(np.float64), im2[m].astype(np.float64)
    n = a.size
    # convention: ordinal ranks by value with index tiebreak (lex sort)
    ra = np.empty(n)
    ra[np.lexsort((np.arange(n), a))] = np.arange(n)
    rb = np.empty(n)
    rb[np.lexsort((np.arange(n), b))] = np.arange(n)
    rmax = max(n - 1, 1)
    w = (rmax - np.abs(ra - rb)) / rmax
    t1, t2 = a.max() * thr_frac, b.max() * thr_frac
    coloc = (a > t1) & (b > t2)
    return {
        "rwc": (a * w)[coloc].sum() / max(a.sum(), 1e-12),
        "rwc_2": (b * w)[coloc].sum() / max(b.sum(), 1e-12),
    }


def o_costes(mask, im1, im2, scale_max=255) -> dict:
    """CellProfiler linear_costes, literal per-pixel implementation:
    Deming regression (ddof=1) over (im1>0)|(im2>0) pixels, descending
    threshold scan T1 = k*max(im1)/scale_max (k = scale_max-1..1) stopping
    at the first k whose below-either-threshold pixels correlate
    non-positively, coefficients over above-both pixels normalized by
    above-own-threshold sums."""
    m = mask.astype(bool)
    a1 = im1[m].astype(np.float64)
    a2 = im2[m].astype(np.float64)
    nz = (a1 > 0) | (a2 > 0)
    x, y = a1[nz], a2[nz]
    nan = {"costes": float("nan"), "costes_2": float("nan")}
    if len(x) < 2:
        return nan
    vx = float(np.var(x, ddof=1))
    vy = float(np.var(y, ddof=1))
    cov = float(((x - x.mean()) * (y - y.mean())).sum() / (len(x) - 1))
    if abs(cov) <= 1e-20:
        return nan
    a = ((vy - vx) + math.sqrt((vy - vx) ** 2 + 4 * cov**2)) / (2 * cov)
    if a <= 0:
        return nan
    b = float(y.mean()) - a * float(x.mean())
    i_step = max(float(a1.max()), 1e-20) / scale_max
    k_star = 1
    for k in range(scale_max - 1, 0, -1):
        t1 = k * i_step
        t2 = a * t1 + b
        reg = (a1 < t1) | (a2 < t2)
        if reg.sum() >= 2:
            xr, yr = a1[reg], a2[reg]
            if xr.var() > 0 and yr.var() > 0:
                c = float(np.corrcoef(xr, yr)[0, 1])
                if c <= 0:
                    k_star = k
                    break
    t1 = k_star * i_step
    t2 = a * t1 + b
    both = (a1 > t1) & (a2 > t2)
    den1 = a1[a1 > t1].sum()
    den2 = a2[a2 > t2].sum()
    if den1 <= 0 or den2 <= 0:
        return nan
    return {
        "costes": float(a1[both].sum() / den1),
        "costes_2": float(a2[both].sum() / den2),
    }


# ---------------------------------------------------------------------------
# zernike / radial distribution (convention-matched numerics)
# ---------------------------------------------------------------------------


def _zernike_pairs(max_n=9):
    return [(n, m) for n in range(max_n + 1) for m in range(n % 2, n + 1, 2)]


def o_minimum_enclosing_circle(mask: np.ndarray):
    """Exact minimum enclosing circle of the object's pixel centers.

    Centrosome convention (``minimum_enclosing_circle`` feeding the zernike
    construction). Candidate points are the per-row x-extent endpoints
    (hull vertices are row-extreme); exhaustive pair+triple circumcircle
    enumeration with full-set enclosure check — exact, test-only speed.
    """
    m = mask.astype(bool)
    ys, xs = np.nonzero(m)
    pts = []
    for y in np.unique(ys):
        row = xs[ys == y]
        pts.append((float(y), float(row.min())))
        pts.append((float(y), float(row.max())))
    P = np.unique(np.array(pts, np.float64), axis=0)
    n = len(P)
    if n == 1:
        return P[0, 0], P[0, 1], 0.0
    cands = []  # (cy, cx, r2)
    for i in range(n):
        for j in range(i + 1, n):
            c = (P[i] + P[j]) / 2.0
            cands.append((c[0], c[1], ((P[i] - P[j]) ** 2).sum() / 4.0))
    for i in range(n):
        for j in range(i + 1, n):
            for k in range(j + 1, n):
                (ay, ax), (by, bx), (cy_, cx_) = P[i], P[j], P[k]
                d = 2.0 * (ax * (by - cy_) + bx * (cy_ - ay) + cx_ * (ay - by))
                if abs(d) < 1e-9:
                    continue
                s0, s1, s2 = ax**2 + ay**2, bx**2 + by**2, cx_**2 + cy_**2
                ux = (s0 * (by - cy_) + s1 * (cy_ - ay) + s2 * (ay - by)) / d
                uy = (s0 * (cx_ - bx) + s1 * (ax - cx_) + s2 * (bx - ax)) / d
                cands.append((uy, ux, (ay - uy) ** 2 + (ax - ux) ** 2))
    best = None
    for cy2, cx2, r2 in cands:
        d2 = ((P[:, 0] - cy2) ** 2 + (P[:, 1] - cx2) ** 2).max()
        if d2 <= r2 * (1 + 1e-9) + 1e-9:
            if best is None or r2 < best[2]:
                best = (cy2, cx2, r2)
    cy2, cx2, r2 = best
    # exact enclosing radius from the chosen center
    r = math.sqrt(((P[:, 0] - cy2) ** 2 + (P[:, 1] - cx2) ** 2).max())
    return cy2, cx2, r


def o_zernike(mask: np.ndarray, weight: np.ndarray | None = None) -> dict:
    """|A_nm| over the object's minimum-enclosing-circle unit disk (the
    centrosome/CellProfiler zernike convention)."""
    m = mask.astype(bool)
    ys, xs = np.nonzero(m)
    cy, cx, rmec = o_minimum_enclosing_circle(m)
    dy, dx = ys - cy, xs - cx
    r = np.hypot(dy, dx)
    rmax = max(rmec, 1.0)
    rho = r / rmax
    theta = np.arctan2(dy, dx)
    w = np.ones_like(rho) if weight is None else weight[m].astype(np.float64)
    inside = rho <= 1.0 + 1e-6
    out = {}
    for n, mm in _zernike_pairs():
        R = np.zeros_like(rho)
        for s in range((n - mm) // 2 + 1):
            c = (
                (-1) ** s * math.factorial(n - s)
                / (math.factorial(s) * math.factorial((n + mm) // 2 - s)
                   * math.factorial((n - mm) // 2 - s))
            )
            R += c * rho ** (n - 2 * s)
        re = (w * R * np.cos(mm * theta) * inside).sum()
        im = (w * R * np.sin(mm * theta) * inside).sum()
        out[(n, mm)] = math.hypot(re, im) * (n + 1) / (math.pi * rmax ** 2)
    return out


def o_radial_distribution(mask, img, n_bins=4, n_wedges=8) -> dict:
    """FracAtD / MeanFrac / RadialCV with CellProfiler's EDT-normalized
    binning: center = most-interior pixel (EDT argmax, first in raster
    order), normalized distance = d_center / (d_center + d_edge + .001)."""
    m = mask.astype(bool)
    ys, xs = np.nonzero(m)
    v = img[m].astype(np.float64)
    d_edge_full = ndimage.distance_transform_edt(m)
    d_edge = d_edge_full[m]
    k = int(np.argmax(d_edge_full.ravel()))  # raster-first argmax
    cy, cx = k // m.shape[1], k % m.shape[1]
    dy, dx = ys - float(cy), xs - float(cx)
    r = np.hypot(dy, dx)
    nd = r / (r + d_edge + 0.001)
    ring = np.clip((nd * n_bins).astype(int), 0, n_bins - 1)
    theta = np.arctan2(dy, dx)
    wedge = np.clip(((theta + np.pi) / (2 * np.pi) * n_wedges).astype(int),
                    0, n_wedges - 1)
    total_i = max(v.sum(), 1e-12)
    total_n = len(v)
    out = {}
    for b in range(n_bins):
        sel = ring == b
        frac_at_d = v[sel].sum() / total_i
        frac_px = sel.sum() / total_n
        mean_frac = frac_at_d / max(frac_px, 1e-12)
        wsum = np.zeros(n_wedges)
        for wd in range(n_wedges):
            wsum[wd] = v[sel & (wedge == wd)].sum()
        wmean = wsum.mean()
        wstd = math.sqrt(max((wsum ** 2).mean() - wmean ** 2, 0.0))
        cv = wstd / max(wmean, 1e-12)
        tag = f"{b + 1}of{n_bins}"
        out[f"RadialDistribution_FracAtD_{tag}"] = frac_at_d
        out[f"RadialDistribution_MeanFrac_{tag}"] = mean_frac
        out[f"RadialDistribution_RadialCV_{tag}"] = cv
    return out


# ---------------------------------------------------------------------------
# granularity (convention-matched: 4-connected cross element, per object)
# ---------------------------------------------------------------------------


def o_granularity(mask, img, n_steps=16) -> dict:
    m = mask.astype(bool)
    masked = np.where(m, img.astype(np.float64), 0.0)

    # same-label-clamped 4-neighbor erosion/dilation: out-of-object -> +/-inf
    def erode_clamped(a):
        pad = np.full((a.shape[0] + 2, a.shape[1] + 2), np.inf)
        pad[1:-1, 1:-1] = np.where(m, a, np.inf)
        out = np.where(m, a, np.inf).copy()
        for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            out = np.minimum(out, pad[1 + dy: -1 + dy or None, 1 + dx: -1 + dx or None])
        return np.where(m, out, 0.0)

    def dilate_clamped(a):
        pad = np.full((a.shape[0] + 2, a.shape[1] + 2), -np.inf)
        pad[1:-1, 1:-1] = np.where(m, a, -np.inf)
        out = np.where(m, a, -np.inf).copy()
        for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            out = np.maximum(out, pad[1 + dy: -1 + dy or None, 1 + dx: -1 + dx or None])
        return np.where(m, out, 0.0)

    start = masked.sum()
    eroded = masked
    prev = start
    out = {}
    for k in range(1, n_steps + 1):
        eroded = erode_clamped(eroded)
        opened = eroded
        for _ in range(k):
            opened = dilate_clamped(opened)
        s = opened[m].sum()
        out[f"Granularity_{k}"] = 100.0 * (prev - s) / max(start, 1e-12)
        prev = s
    return out


# ---------------------------------------------------------------------------
# texture (Haralick GLCM, per-object min-max quantization to NG levels)
# ---------------------------------------------------------------------------

HARALICK_NAMES = (
    "AngularSecondMoment", "Contrast", "Correlation", "Variance",
    "InverseDifferenceMoment", "SumAverage", "SumVariance", "SumEntropy",
    "Entropy", "DifferenceVariance", "DifferenceEntropy", "InfoMeas1",
    "InfoMeas2",
)


def _plog(x):
    return np.where(x > 1e-12, np.log(np.maximum(x, 1e-12)), 0.0)


def o_texture(mask, img, scale=3, ng=256) -> dict:
    """13 Haralick features x 4 angles from the standard GLCM definitions."""
    m = mask.astype(bool)
    v = img.astype(np.float64)
    vmin, vmax = v[m].min(), v[m].max()
    span = max(vmax - vmin, 1e-12)
    q = np.clip(((v - vmin) / span * ng).astype(int), 0, ng - 1)
    out = {}
    for a_idx, (dy, dx) in enumerate(((0, 1), (1, 1), (1, 0), (1, -1))):
        oy, ox = dy * scale, dx * scale
        H, W = m.shape
        ys = slice(max(0, -oy), H - max(0, oy))
        xs = slice(max(0, -ox), W - max(0, ox))
        ys2 = slice(max(0, oy), H - max(0, -oy))
        xs2 = slice(max(0, ox), W - max(0, -ox))
        valid = m[ys, xs] & m[ys2, xs2]
        P = np.zeros((ng, ng))
        np.add.at(P, (q[ys, xs][valid], q[ys2, xs2][valid]), 1.0)
        P = P + P.T
        if P.sum() == 0:
            for name in HARALICK_NAMES:
                out[f"Texture_{name}_{scale}_{a_idx:02d}_256"] = np.nan
            continue
        P = P / P.sum()
        i = np.arange(ng, dtype=float)
        ii, jj = np.meshgrid(i, i, indexing="ij")
        px, py = P.sum(1), P.sum(0)
        mu_x, mu_y = (px * i).sum(), (py * i).sum()
        var_x = (px * (i - mu_x) ** 2).sum()
        var_y = (py * (i - mu_y) ** 2).sum()
        sd = math.sqrt(max(var_x * var_y, 1e-12))
        p_sum = np.zeros(2 * ng - 1)
        np.add.at(p_sum, (ii + jj).astype(int).ravel(), P.ravel())
        p_diff = np.zeros(ng)
        np.add.at(p_diff, np.abs(ii - jj).astype(int).ravel(), P.ravel())
        k_sum = np.arange(2 * ng - 1, dtype=float)
        k_diff = np.arange(ng, dtype=float)
        sum_avg = (p_sum * k_sum).sum()
        diff_avg = (p_diff * k_diff).sum()
        entropy = -(P * _plog(P)).sum()
        hx = -(px * _plog(px)).sum()
        hy = -(py * _plog(py)).sum()
        pxy = px[:, None] * py[None, :]
        hxy1 = -(P * _plog(pxy)).sum()
        hxy2 = -(pxy * _plog(pxy)).sum()
        feats = {
            "AngularSecondMoment": (P ** 2).sum(),
            "Contrast": (P * (ii - jj) ** 2).sum(),
            "Correlation": ((P * (ii - mu_x) * (jj - mu_y)).sum() / sd
                            if sd > 1e-6 else 0.0),
            "Variance": (P * (ii - mu_x) ** 2).sum(),
            "InverseDifferenceMoment": (P / (1.0 + (ii - jj) ** 2)).sum(),
            "SumAverage": sum_avg,
            "SumVariance": (p_sum * (k_sum - sum_avg) ** 2).sum(),
            "SumEntropy": -(p_sum * _plog(p_sum)).sum(),
            "Entropy": entropy,
            "DifferenceVariance": (p_diff * (k_diff - diff_avg) ** 2).sum(),
            "DifferenceEntropy": -(p_diff * _plog(p_diff)).sum(),
            "InfoMeas1": (entropy - hxy1) / max(max(hx, hy), 1e-12),
            "InfoMeas2": math.sqrt(max(1.0 - math.exp(-2.0 * (hxy2 - entropy)), 0.0)),
        }
        for name in HARALICK_NAMES:
            out[f"Texture_{name}_{scale}_{a_idx:02d}_256"] = feats[name]
    return out
