"""Texture, granularity, zernike and radial-distribution feature families
(counterpart of ``aliby_tpu/extract/texture.py``).

Batched like ``extract/features.py``: ``(B, H, W)`` labels (and images) ->
``{CellProfiler_feature_name: (B, max_labels)}``, absent labels NaN, where
the reference maps one image with ``jax.vmap``.

- texture: 13 Haralick features x 4 angles from per-object 256-level
  co-occurrence matrices, in the reference's sort-based sparse form (sorted
  integer cell keys, run lengths, group sums as differences of a running
  sum read at the group boundaries).
- granularity: the granulometry spectrum (same-label 4-neighbour grayscale
  openings of growing size, % of intensity removed per step).
- zernike, radial_zernikes: ``|A_nm|`` for n <= 9 over each object's minimum
  enclosing circle, mask- or intensity-weighted; a tree's entries share one
  geometry pass (:func:`zernike_family_multi`).
- radial_distribution: FracAtD / MeanFrac / RadialCV over 4 rings of
  CellProfiler's EDT-normalised distance about each object's most interior
  pixel, with 8 angular wedges for the CV.

Images on this path are finite. Float-to-int casts (texture's gray levels,
the ring and wedge indices) clamp in floating point first, so an
out-of-range value (a background pixel read against label 1's range) casts
the same way on every device.
"""

from __future__ import annotations

import math

import torch

from aliby_tpu_torch.extract.features import _nanpad
from aliby_tpu_torch.extract.reductions import (
    INF,
    LabelStats,
    _div,
    _label_index,
    _shifted,
    binned_sum_cols,
    counts,
    minimum_enclosing_circle,
    seg_minmax_cols,
    seg_sum,
    seg_sum_cols,
    table_lookup,
)
from aliby_tpu_torch.ops.edt import edt_to_other_label
from aliby_tpu_torch.ops.imageops import _sqrt

# ---------------------------------------------------------------------------
# Haralick texture
# ---------------------------------------------------------------------------

_NG = 256  # gray levels: the _256 scale suffix of the CellProfiler names
_ANGLE_OFFSETS = ((0, 1), (1, 1), (1, 0), (1, -1))  # 00, 01, 02, 03
_HARALICK_NAMES = (
    "AngularSecondMoment",
    "Contrast",
    "Correlation",
    "Variance",
    "InverseDifferenceMoment",
    "SumAverage",
    "SumVariance",
    "SumEntropy",
    "Entropy",
    "DifferenceVariance",
    "DifferenceEntropy",
    "InfoMeas1",
    "InfoMeas2",
)


def _run_lengths(sk: torch.Tensor, nbig: int):
    """Per-element run length of each row of a SORTED (B, N) int key array
    (exact): run starts by neighbour compare, start positions by a running
    max, run ends by a reverse running min of the next start position.
    Returns ``(lengths (B, N) int32, run_starts (B, N) bool)``."""
    B, n = sk.shape
    dev = sk.device
    iota = torch.arange(n, dtype=torch.int32, device=dev).expand(B, n)
    rs = torch.cat([torch.ones(B, 1, dtype=torch.bool, device=dev), sk[:, 1:] != sk[:, :-1]], dim=1)
    start = torch.cummax(torch.where(rs, iota, -1), dim=1).values
    nxt = torch.cat([torch.where(rs, iota, int(nbig))[:, 1:],
                     torch.full((B, 1), n, dtype=torch.int32, device=dev)], dim=1)
    end = torch.cummin(nxt.flip(1), dim=1).values.flip(1)
    return end - start, rs


def quantize(labels: torch.Tensor, img: torch.Tensor, max_labels: int) -> torch.Tensor:
    """(B, H, W) int32 gray levels in [0, 256): each object's pixels scaled
    to its own (min, max) range; one min/max pass and one 2-column lookup."""
    G = _NG
    mn, mx = seg_minmax_cols(img.unsqueeze(-1), labels, max_labels)
    vmin = torch.nan_to_num(mn[..., 0], posinf=0.0)
    vmax = torch.nan_to_num(mx[..., 0], neginf=0.0)
    span = (vmax - vmin).clamp_min(1e-12)
    lk = table_lookup(torch.stack([vmin, span], dim=-1), _label_index(labels, max_labels))
    level = (img - lk[..., 0]) / lk[..., 1] * G
    # clamp before the cast (see the module docstring), then as the reference
    return torch.nan_to_num(level, nan=0.0).clamp(0.0, float(G)).to(torch.int32).clamp(0, G - 1)


def texture(labels: torch.Tensor, img: torch.Tensor, max_labels: int, scale: int = 3) -> dict:
    """13 Haralick features x 4 angles from per-object 256-level GLCMs.

    The reference's sort-based sparse form: a symmetric GLCM holds at most
    H*W nonzero cells, so every histogram-shaped term comes from sorting
    compact integer keys and run-length encoding them.

    - Terms linear in P (contrast, IDM, the sum/diff moments, E[ij], the
      marginal mean and variance) are functions of the (q0+q1, |q0-q1|)
      pair that the sorted joint key encodes.
    - ASM and entropy need each pair's symmetric cell count s: the key
      (angle, label, q0+q1, |q0-q1|) is a bijection of the cell; a run of
      length r gives s = r off the diagonal and 2r on it; then
      sum_cells s^2 = sum_el 2 s_el and the entropy is
      [-2 sum_el log s_el] / T + log T. The sum-major order makes the
      (angle, label, q0+q1) slices contiguous, so the sum-marginal entropy
      is a second run-length pass over the same sorted keys.
    - The endpoint and difference marginal entropies sort their own keys.

    Per-(angle, label) totals are differences of one running sum over the
    sorted elements, read at the group boundaries (``searchsorted``). The
    running sum is float64 here (f32 in the reference): the integer-valued
    columns are then exact in any order, so the CPU and the card agree, and
    late groups lose nothing to the magnitude of the running total.

    Keys stay inside int32 per image (134.7 M at 256 labels); each image
    sorts its own row.
    """
    img = img.to(torch.float32)
    dev = labels.device
    B, H, W = labels.shape
    present = counts(labels, max_labels) > 0
    G = _NG
    q = quantize(labels, img, max_labels)
    A = len(_ANGLE_OFFSETS)
    L1 = max_labels + 1
    # all 4 angles' pair slots, angle-tagged; invalid slots carry label 0 and
    # land in each angle's label-0 groups, which every [:, :, 1:] slice drops
    lbls, q0s, q1s, angs = [], [], [], []
    for a, (dy, dx) in enumerate(_ANGLE_OFFSETS):
        oy, ox = dy * scale, dx * scale
        ys = slice(max(0, -oy), H - max(0, oy))
        xs = slice(max(0, -ox), W - max(0, ox))
        ys2 = slice(max(0, oy), H - max(0, -oy))
        xs2 = slice(max(0, ox), W - max(0, -ox))
        l0 = labels[:, ys, xs].reshape(B, -1)
        l1 = labels[:, ys2, xs2].reshape(B, -1)
        valid = (l0 > 0) & (l0 == l1)
        lbls.append(torch.where(valid, l0, 0).to(torch.int32))
        q0s.append(q[:, ys, xs].reshape(B, -1))
        q1s.append(q[:, ys2, xs2].reshape(B, -1))
        angs.append(torch.full((l0.shape[1],), a, dtype=torch.int32, device=dev))
    lbl = torch.cat(lbls, dim=1)
    q0i = torch.cat(q0s, dim=1)
    q1i = torch.cat(q1s, dim=1)
    ang = torch.cat(angs)
    N = lbl.shape[1]
    LA = A * L1
    G2 = 2 * G
    if LA * G2 * G >= 2 ** 31:
        raise ValueError(f"max_labels {max_labels} overflows the int32 cell key")
    al = ang * L1 + lbl  # (angle, label) flat group id

    def group_sums(sorted_keys, cols, span):
        """(B, C, A, max_labels) totals of the C (B, N) columns ``cols``
        over the groups of the sorted keys ``group * span + value``. The
        running sum runs along the innermost axis of a (B, C, N) block."""
        invalid = (torch.div(sorted_keys, span, rounding_mode="floor") % L1 == 0).unsqueeze(1)
        vals = torch.stack(cols, dim=1).to(torch.float64)
        vals = torch.where(invalid, torch.zeros((), dtype=torch.float64, device=dev), vals)
        cs = torch.cat([torch.zeros(B, len(cols), 1, dtype=torch.float64, device=dev),
                        torch.cumsum(vals, dim=-1)], dim=-1)
        edges = (torch.arange(LA + 1, dtype=torch.int32, device=dev) * span).expand(B, -1)
        pos = torch.searchsorted(sorted_keys, edges.contiguous())
        idx = pos.unsqueeze(1).expand(-1, len(cols), -1)
        tot = torch.gather(cs, 2, idx[..., 1:]) - torch.gather(cs, 2, idx[..., :-1])
        return tot.to(torch.float32).reshape(B, len(cols), A, L1)[..., 1:]

    # ---- joint sort: every linear statistic, ASM and the entropies --------
    sm = q0i + q1i
    df = (q0i - q1i).abs()
    jkey = (al * G2 + sm) * G + df
    sjk = torch.sort(jkey, dim=1).values
    rlen, _ = _run_lengths(sjk, N + G2 * G * LA)
    s_sum = (torch.div(sjk, G, rounding_mode="floor") % G2).to(torch.float32)  # q0+q1
    s_df = (sjk % G).to(torch.float32)  # |q0-q1|
    s_cell = torch.where(s_df == 0, 2 * rlen, rlen).to(torch.float32)
    # run lengths of the (angle, label, sum) regions: the sum-marginal counts
    rlen_sum, _ = _run_lengths(torch.div(sjk, G, rounding_mode="floor"), N + G2 * LA)
    acc = group_sums(
        sjk,
        [
            torch.ones_like(s_df),  # pair count n
            s_df * s_df,  # contrast
            1.0 / (1.0 + s_df * s_df),  # inverse difference moment
            s_sum,  # sum average numerator
            s_sum * s_sum,  # sum 2nd moment
            s_df,  # diff average numerator
            _div(s_sum * s_sum - s_df * s_df, 4.0),  # E[ij] (qmin * qmax)
            _div(s_sum * s_sum + s_df * s_df, 2.0),  # endpoint 2nd moment
            2.0 * s_cell,  # ASM numerator
            -2.0 * torch.log(s_cell),  # joint entropy numerator
            -torch.log(rlen_sum.to(torch.float32)),  # sum-marginal entropy
        ],
        G2 * G,
    )  # (B, 11, A, L)
    n_pairs = acc[:, 0]
    T = (2.0 * n_pairs).clamp_min(1e-12)
    logT = torch.log(T)
    asm = acc[:, 8] / (T * T)
    entropy = acc[:, 9] / T + logT
    ment_sums = acc[:, 10]

    # ---- the remaining marginal entropies: hx, diff entropy ---------------
    # -sum_v m log m == -sum_el log(run length of el's value) over a sort of
    # value-tagged keys
    def ment(keys, span):
        sk = torch.sort(keys, dim=1).values
        rl, _ = _run_lengths(sk, keys.shape[1])
        return group_sums(sk, [-torch.log(rl.to(torch.float32))], span)[:, 0]

    ment_ends = ment(torch.cat([al * G + q0i, al * G + q1i], dim=1), G)
    ment_diffs = ment(al * G + df, G)
    inv_n = 1.0 / n_pairs.clamp_min(1e-12)
    logn = torch.log(n_pairs.clamp_min(1e-12))
    hx = ment_ends / T + logT
    sum_ent = ment_sums * inv_n + logn
    diff_ent = ment_diffs * inv_n + logn

    # ---- assemble the 13 features -----------------------------------------
    contrast = acc[:, 1] * inv_n
    idm = acc[:, 2] * inv_n
    sum_avg = acc[:, 3] * inv_n
    sum_var = (acc[:, 4] * inv_n - sum_avg * sum_avg).clamp_min(0.0)
    diff_avg = acc[:, 5] * inv_n
    diff_var = (contrast - diff_avg * diff_avg).clamp_min(0.0)
    e_ij = acc[:, 6] * inv_n
    mu = _div(sum_avg, 2.0)
    # marginal variance over both endpoints: E[v^2] - mu^2 (T = 2n endpoints)
    var = (acc[:, 7] / T - mu * mu).clamp_min(0.0)
    corr = ((e_ij - mu * mu) / var.clamp_min(1e-12)) * (var > 1e-6)
    # separable joint-entropy bounds: hxy1 == hxy2 == hx + hy == 2 hx
    im1 = (entropy - 2.0 * hx) / hx.clamp_min(1e-12)
    im2 = _sqrt((1.0 - torch.exp(-2.0 * (2.0 * hx - entropy))).clamp_min(0.0))
    feats = dict(zip(_HARALICK_NAMES, (asm, contrast, corr, var, idm, sum_avg, sum_var,
                                       sum_ent, entropy, diff_var, diff_ent, im1, im2)))
    has_pairs = n_pairs > 0
    out = {}
    for a_idx in range(A):
        ok = present & has_pairs[:, a_idx]
        for name, v in feats.items():
            out[f"Texture_{name}_{scale}_{a_idx:02d}_256"] = _nanpad(v[:, a_idx], ok)
    return out


# ---------------------------------------------------------------------------
# Granularity
# ---------------------------------------------------------------------------

_OFFS4 = ((-1, 0), (1, 0), (0, -1), (0, 1))


def _same_label_morph_ops(labels: torch.Tensor):
    """(erode, dilate) closures over (B, H, W) images with the same-label
    4-neighbour masks taken once: labels do not change across the ~150
    morphology passes of a granularity spectrum."""
    l_pad = torch.nn.functional.pad(labels, (1, 1, 1, 1), value=-1)
    same = {off: _shifted(l_pad, *off) == labels for off in _OFFS4}

    def morph(img, pad_value, pick):
        a_pad = torch.nn.functional.pad(img, (1, 1, 1, 1), value=pad_value)
        fill = torch.full((), pad_value, device=img.device)
        out = img
        for off, m in same.items():
            out = pick(out, torch.where(m, _shifted(a_pad, *off), fill))
        return out

    def erode(img):
        return morph(img, INF, torch.minimum)

    def dilate(img):
        return morph(img, -INF, torch.maximum)

    return erode, dilate


def granularity(labels: torch.Tensor, img: torch.Tensor, max_labels: int,
                n_steps: int = 16) -> dict:
    """Granularity spectrum: % of intensity removed by an opening of size k."""
    img = img.to(torch.float32)
    fg = labels > 0
    zero = torch.zeros((), device=labels.device)
    present = counts(labels, max_labels) > 0
    masked = torch.where(fg, img, zero)
    erode, dilate = _same_label_morph_ops(labels)

    eroded = masked
    opened_cols = [masked]
    for k in range(1, n_steps + 1):
        eroded = erode(eroded)
        opened = eroded
        for _ in range(k):
            opened = dilate(opened)
        opened_cols.append(torch.where(fg, opened, zero))
    # all n_steps + 1 per-label sums in one pass
    sums = seg_sum_cols(torch.stack(opened_cols, dim=-1), labels, max_labels)
    start = sums[..., 0]
    safe_start = start.clamp_min(1e-12)
    out = {}
    prev = start
    for k in range(1, n_steps + 1):
        g = 100.0 * (prev - sums[..., k]) / safe_start
        out[f"Granularity_{k}"] = _nanpad(g, present)
        prev = sums[..., k]
    return out


# ---------------------------------------------------------------------------
# Zernike moments
# ---------------------------------------------------------------------------


def _zernike_pairs(max_n: int = 9):
    pairs = []
    for n in range(max_n + 1):
        for m in range(n % 2, n + 1, 2):
            pairs.append((n, m))
    return pairs


def _atan2(dy: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """f32 ``atan2`` taken in float64 and rounded once: the same bits on the
    CPU and the card (their f32 ``atan2`` differ by an ulp on some inputs,
    which decides the wedge of a pixel that sits on a wedge edge)."""
    return torch.atan2(dy.to(torch.float64), dx.to(torch.float64)).to(torch.float32)


def zernike_family_multi(labels: torch.Tensor, imgs: torch.Tensor, with_mask: bool,
                         max_labels: int):
    """All zernike-family entries of a tree in one geometry pass.

    ``|A_nm|`` over each object's minimum-enclosing-circle unit disk (the
    centrosome/CellProfiler convention). The weight factors out of the
    integrand: the 60 polynomial rasters ``R_nm cos/sin`` are built once,
    and every entry (the mask entry, then one per image) contributes its
    ``w * Z`` columns plus one non-finite indicator column, so that a
    non-finite weight poisons its own entry and label only.

    The reference stacks all entries' columns into one 366-column reduction;
    here each entry's 61 columns go through :func:`seg_sum_cols` on their
    own, which gives the same bits (a column's sum does not depend on its
    neighbours, and the weighted columns are finite by construction, so the
    shared flag never fires) and keeps the temporaries at one entry's size.

    ``imgs``: (B, C', H, W) intensity rasters for the radial entries (C' may
    be 0); ``with_mask``: whether to emit the unweighted entry. Returns
    ``(mask_dict_or_None, [dict per image])`` with {(n, m): (B, L)} values.
    """
    dev = labels.device
    zero = torch.zeros((), device=dev)
    st = LabelStats(labels, max_labels)
    present = st.present
    l_idx = _label_index(labels, max_labels)
    mcy, mcx, mr = minimum_enclosing_circle(labels, max_labels)
    rmax = torch.where(torch.isfinite(mr), mr, torch.ones((), device=dev)).clamp_min(1.0)
    lk = table_lookup(torch.stack([mcy, mcx, rmax], dim=-1), l_idx)
    dy = st.yy - lk[..., 0]
    dx = st.xx - lk[..., 1]
    r = _sqrt(dy * dy + dx * dx)
    rho = r / lk[..., 2]
    theta = _atan2(dy, dx)
    fg = labels > 0
    inside = fg & (rho <= 1.0 + 1e-6)

    # per-entry weight rasters ----------------------------------------------
    ws = []
    if with_mask:
        ws.append(inside.to(torch.float32))
    nC = int(imgs.shape[1])
    if nC:
        imf = imgs.to(torch.float32)
        # per-object intensity totals of all channels in one pass (the
        # magnitudes become scale-free, as upstream)
        masked = torch.where(fg.unsqueeze(1), torch.nan_to_num(imf), zero)
        tots = seg_sum_cols(masked.movedim(1, -1), labels, max_labels)  # (B, L, C')
        inv = table_lookup(1.0 / tots.clamp_min(1e-12), l_idx)  # (B, H, W, C')
        for c in range(nC):
            ws.append(torch.where(inside, imf[:, c] * inv[..., c], zero))

    pairs = _zernike_pairs()
    max_n = max(n for n, _ in pairs)
    pows = [torch.ones_like(rho)]
    for _ in range(max_n):
        pows.append(pows[-1] * rho)
    zcols = []
    for n, m in pairs:
        R = torch.zeros_like(rho)
        for s in range((n - m) // 2 + 1):
            c = ((-1) ** s * math.factorial(n - s)
                 / (math.factorial(s) * math.factorial((n + m) // 2 - s)
                    * math.factorial((n - m) // 2 - s)))
            R = R + c * pows[n - 2 * s]
        zcols.append(R * torch.cos(m * theta))
        zcols.append(R * torch.sin(m * theta))
    Z = torch.stack(zcols, dim=-1)  # (B, H, W, 60), weight-independent
    K = Z.shape[-1]
    norm_r2 = math.pi * (rmax * rmax)

    def entry(w):
        finite = torch.isfinite(w)
        wc = torch.where(finite, w, zero)
        vals = torch.cat([Z * wc.unsqueeze(-1), (~finite).to(torch.float32).unsqueeze(-1)], dim=-1)
        acc = seg_sum_cols(vals, labels, max_labels)  # (B, L, K + 1)
        ok = present & ~(acc[..., K] > 0)
        out = {}
        for i, (n, m) in enumerate(pairs):
            re, im = acc[..., 2 * i], acc[..., 2 * i + 1]
            mag = _sqrt(re * re + im * im) * ((n + 1) / norm_r2)
            out[(n, m)] = _nanpad(mag, ok)
        return out

    outs = [entry(w) for w in ws]
    mask_out = outs.pop(0) if with_mask else None
    return mask_out, outs


def zernike(labels: torch.Tensor, max_labels: int) -> dict:
    empty = torch.zeros((labels.shape[0], 0) + labels.shape[1:], device=labels.device)
    vals, _ = zernike_family_multi(labels, empty, True, max_labels)
    return {f"Zernike_{n}_{m}": v for (n, m), v in vals.items()}


def radial_zernikes(labels: torch.Tensor, img: torch.Tensor, max_labels: int) -> dict:
    """Intensity-weighted zernike magnitudes (cp_measure radial_zernikes)."""
    _, outs = zernike_family_multi(labels, img.unsqueeze(1), False, max_labels)
    return {f"RadialZernike_{n}_{m}": v for (n, m), v in outs[0].items()}


# ---------------------------------------------------------------------------
# Radial distribution
# ---------------------------------------------------------------------------


def _most_interior_pixel(labels: torch.Tensor, d_edge: torch.Tensor, max_labels: int):
    """(B, max_labels) raster index of each label's most interior pixel: the
    argmax of its EDT, the first in raster order among equals (0 for an
    absent label). The EDT is the square root of an integer, so the argmax
    is an integer scatter-min (order-free, hence the same on every run)."""
    B, H, W = labels.shape
    dev = labels.device
    flat_l = labels.clamp(0, max_labels).reshape(B, -1).to(torch.int64)
    fgf = (labels > 0).reshape(B, -1)
    pos = torch.arange(H * W, dtype=torch.int32, device=dev).expand(B, -1)
    i32max = torch.iinfo(torch.int32).max
    big = torch.full((), i32max, dtype=torch.int32, device=dev)
    d2i = torch.round(d_edge * d_edge).to(torch.int32).reshape(B, -1)

    def scatter_min(where, values):
        out = torch.full((B, max_labels + 1), i32max, dtype=torch.int32, device=dev)
        return out.scatter_reduce_(1, torch.where(where, flat_l, 0), torch.where(where, values, big),
                                   "amin")

    if H * W <= (1 << 16):
        # one packed key: the largest d^2 first, then the lowest position
        cap = (1 << 15) - 2
        key = ((cap - d2i.clamp_max(cap)) << 16) | pos
        return scatter_min(fgf, key)[:, 1:] & 0xFFFF
    # the position overflows 16 bits: the negated integer distance per label,
    # then the lowest position among the pixels that reach it
    neg_best = scatter_min(fgf, -d2i)
    at_best = fgf & (d2i == -torch.gather(neg_best, 1, flat_l))
    first = scatter_min(at_best, pos)[:, 1:]
    return torch.where(first == i32max, 0, first)


def _rings_and_wedges(labels: torch.Tensor, max_labels: int, n_bins: int, n_wedges: int):
    """Per-pixel (ring, wedge) int32 rasters of the radial distribution and
    the distance to the object's edge."""
    st = LabelStats(labels, max_labels)
    B, H, W = labels.shape
    d_edge = edt_to_other_label(labels)
    first = _most_interior_pixel(labels, d_edge, max_labels)
    ccy = torch.div(first, W, rounding_mode="floor")
    ccx = first - ccy * W
    cc = table_lookup(torch.stack([ccy, ccx], dim=-1).to(torch.float32),
                      _label_index(labels, max_labels))
    dy = st.yy - cc[..., 0]
    dx = st.xx - cc[..., 1]
    r = _sqrt(dy * dy + dx * dx)
    nd = r / (r + d_edge + 0.001)
    ring = (nd * n_bins).clamp(0.0, float(n_bins)).to(torch.int32).clamp(0, n_bins - 1)
    theta = _atan2(dy, dx)  # -pi..pi
    turn = _div(theta + math.pi, 2 * math.pi) * n_wedges
    wedge = turn.clamp(0.0, float(n_wedges)).to(torch.int32).clamp(0, n_wedges - 1)
    return st, ring, wedge


def _mean_in_order(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last (short) axis, added left to right: a reduction
    kernel's order differs between the CPU and the card, and RadialCV's
    variance cancels to the last bits of these means."""
    total = x[..., 0]
    for i in range(1, x.shape[-1]):
        total = total + x[..., i]
    return _div(total, float(x.shape[-1]))


def radial_distribution(labels: torch.Tensor, img: torch.Tensor, max_labels: int,
                        n_bins: int = 4, n_wedges: int = 8) -> dict:
    """FracAtD / MeanFrac / RadialCV with CellProfiler's EDT-normalised
    binning (MeasureObjectIntensityDistribution): the object's centre is its
    most interior pixel (the argmax of its EDT, the first in raster order
    among equals), and a pixel's normalised distance is
    ``d_centre / (d_centre + d_edge + 0.001)``: 0 at the centre, towards 1
    at the boundary whatever the shape. The wedges of RadialCV are the 8
    angular sectors about that centre."""
    img = img.to(torch.float32)
    dev = labels.device
    zero = torch.zeros((), device=dev)
    st, ring, wedge = _rings_and_wedges(labels, max_labels, n_bins, n_wedges)
    present = st.present
    fg = labels > 0
    img_m = torch.where(fg, img, zero)
    total_i = seg_sum(img_m, labels, max_labels).clamp_min(1e-12)
    total_n = st.area.clamp_min(1.0)
    # one (2 + n_wedges)-column pass over (label, ring) bins: intensity sum,
    # pixel count and the wedge-partitioned intensity sums (wedge membership
    # as one-hot columns)
    flat_lr = torch.where(fg, labels, 0) * n_bins + ring
    wedge_oh = (wedge.unsqueeze(-1)
                == torch.arange(n_wedges, dtype=torch.int32, device=dev)).to(torch.float32)
    cols = torch.cat([img_m.unsqueeze(-1), fg.to(torch.float32).unsqueeze(-1),
                      img_m.unsqueeze(-1) * wedge_oh], dim=-1)
    acc = binned_sum_cols(cols, flat_lr, (max_labels + 1) * n_bins).reshape(
        labels.shape[0], max_labels + 1, n_bins, 2 + n_wedges)[:, 1:]
    ring_i = acc[..., 0]
    ring_n = acc[..., 1]
    rw_i = acc[..., 2:]
    out = {}
    for b in range(n_bins):
        frac_at_d = ring_i[..., b] / total_i
        frac_px = ring_n[..., b] / total_n
        mean_frac = frac_at_d / frac_px.clamp_min(1e-12)
        wvals = rw_i[:, :, b, :]
        wmean = _mean_in_order(wvals)
        wstd = _sqrt((_mean_in_order(wvals * wvals) - wmean * wmean).clamp_min(0.0))
        cv = wstd / wmean.clamp_min(1e-12)
        tag = f"{b + 1}of{n_bins}"
        for name, v in (("FracAtD", frac_at_d), ("MeanFrac", mean_frac), ("RadialCV", cv)):
            out[f"RadialDistribution_{name}_{tag}"] = _nanpad(v, present)
    return out
