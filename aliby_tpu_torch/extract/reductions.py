"""Per-label reductions (counterpart of ``aliby_tpu/extract/reductions.py``).

Every function is batched: labels are ``(B, H, W)`` (or ``(B, ...)``) and a
per-label result is ``(B, max_labels)`` with label k at column k-1, where
the reference maps one image with ``jax.vmap``. The reference's batching
rules on the TPU become direct calls of the batched wrappers of
``ops/segsum.py``: sums through :func:`binned_sum_cols` (with the kernel
path's non-finite rule), min/max through ``binned_minmax_batched`` and
per-pixel broadcasts of per-label values through ``table_lookup_batched``.

Constants divide as IEEE divisions on every device (``_div``), square roots
are correctly rounded on every device (``ops.imageops._sqrt``), and integer
powers multiply in the reference's square-and-multiply order (``_ipow``),
so the CPU and the card compute the same bits as far as the reductions'
summation order allows. The top-k mean takes its running sum in the
reference backend's order (``ops.imageops.cumsum_xla``).
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from aliby_tpu_torch.ops.imageops import _monotone_key, _sqrt, cumsum_xla
from aliby_tpu_torch.ops.segsum import (
    MAX_COLS,
    binned_minmax_batched,
    binned_sum_cols_batched,
    table_lookup_batched,
)

INF = float("inf")


def _div(a: torch.Tensor, b) -> torch.Tensor:
    """a / b as an IEEE division on every device (a CPU scalar divisor
    becomes a multiply by its reciprocal in PyTorch's CUDA kernels)."""
    if not isinstance(b, torch.Tensor):
        b = torch.full((), b, dtype=a.dtype, device=a.device)
    return torch.div(a, b)


_SUM_GROUP = MAX_COLS - 1  # value columns per pass of the sum kernel


def _ipow(x: torch.Tensor, n: int) -> torch.Tensor:
    """x**n for a small int n in ``lax.integer_pow``'s order of products."""
    if n == 0:
        return torch.ones_like(x)
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return acc


def _iota(labels: torch.Tensor, dtype=torch.float32):
    """(B, H, W) row and column coordinates of a (B, H, W) label stack."""
    B, H, W = labels.shape
    yy = torch.arange(H, dtype=dtype, device=labels.device).reshape(1, H, 1).expand(B, H, W)
    xx = torch.arange(W, dtype=dtype, device=labels.device).reshape(1, 1, W).expand(B, H, W)
    return yy, xx


def binned_sum_cols(values: torch.Tensor, bins: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Batched per-bin sums: (B, ..., K) values, (B, ...) int bins ->
    (B, n_bins, K), bin 0 kept, bins outside [0, n_bins) dropped.

    Non-finite values follow the reference's kernel path
    (``_binned_sum_kernel_call``): they ride a sanitised column plus an
    indicator column, and a bin that received any non-finite value holds
    NaN in all K columns (an ``+inf`` input gives NaN, not ``+inf``). The
    same rule holds on the CPU and the GPU.

    The sum kernel takes 32 columns, so the K columns go in groups of at
    most 31, each beside the one indicator column (taken over all K). A
    column's sum does not depend on what rides beside it, so the grouping
    changes no bit; it runs on every device.
    """
    if values.shape[-1] == 0:
        raise ValueError("binned_sum_cols needs at least one column")
    values = values.to(torch.float32)
    finite = torch.isfinite(values)
    flag = (~finite).any(dim=-1, keepdim=True).to(torch.float32)
    zero = torch.zeros((), device=values.device)
    sums = []
    for k0 in range(0, values.shape[-1], _SUM_GROUP):
        cols = slice(k0, k0 + _SUM_GROUP)
        clean = torch.where(finite[..., cols], values[..., cols], zero)
        out = binned_sum_cols_batched(torch.cat([clean, flag], dim=-1), bins, int(n_bins))
        sums.append(out[..., :-1])
    flagged = out[..., -1:] > 0  # the same indicator sums in every group
    nan = torch.full((), float("nan"), device=values.device)
    return torch.where(flagged, nan, sums[0] if len(sums) == 1 else torch.cat(sums, dim=-1))


def seg_sum_cols(values: torch.Tensor, labels: torch.Tensor, max_labels: int) -> torch.Tensor:
    """Per-label sums of K columns: (B, ..., K) values, (B, ...) labels ->
    (B, max_labels, K); label 0 and labels above max_labels are dropped."""
    return binned_sum_cols(values, labels, int(max_labels) + 1)[:, 1:]


def seg_sum(values: torch.Tensor, labels: torch.Tensor, max_labels: int) -> torch.Tensor:
    if values.dim() == labels.dim():
        values = values.unsqueeze(-1)
    return seg_sum_cols(values, labels, max_labels)[..., 0]


def counts(labels: torch.Tensor, max_labels: int) -> torch.Tensor:
    """(B, max_labels) f32 pixel counts per label."""
    ones = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    return seg_sum(ones, labels, max_labels)


def seg_minmax_cols(values: torch.Tensor, labels: torch.Tensor, max_labels: int):
    """Per-label (min, max) of K columns -> two (B, max_labels, K); absent
    labels hold (+inf, -inf)."""
    mn, mx = binned_minmax_batched(values, labels, int(max_labels) + 1)
    return mn[:, 1:], mx[:, 1:]


def _seg_scatter(values, labels, max_labels, init, reduce):
    B = labels.shape[0]
    flat = labels.reshape(B, -1).to(torch.int64)
    ok = (flat >= 0) & (flat <= max_labels)
    idx = torch.where(ok, flat, max_labels + 1)  # out of range -> spare column
    out = torch.full((B, max_labels + 2), float(init), device=labels.device)
    out.scatter_reduce_(1, idx, values.reshape(B, -1).to(torch.float32), reduce)
    return out[:, 1:-1]


def seg_min(values, labels, max_labels: int, init: float = INF) -> torch.Tensor:
    if init != INF:  # rare custom-init callers keep the scatter path
        return _seg_scatter(values, labels, max_labels, init, "amin")
    return seg_minmax_cols(values.unsqueeze(-1), labels, max_labels)[0][..., 0]


def seg_max(values, labels, max_labels: int, init: float = -INF) -> torch.Tensor:
    if init != -INF:
        return _seg_scatter(values, labels, max_labels, init, "amax")
    return seg_minmax_cols(values.unsqueeze(-1), labels, max_labels)[1][..., 0]


def table_lookup(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` per image for a small (B, L, K) table and (B, ...)
    int indices -> (B, ..., K). Indices are clipped to the table, as in the
    reference; a non-finite entry reads as NaN (the kernel path's rule)."""
    return table_lookup_batched(table, idx.clamp(0, table.shape[1] - 1))


def _label_index(labels: torch.Tensor, max_labels: int) -> torch.Tensor:
    return (labels - 1).clamp(0, max_labels - 1)


class LabelStats:
    """Shared per-label accumulators computed once per label stack."""

    def __init__(self, labels: torch.Tensor, max_labels: int):
        self.labels = labels
        self.max_labels = max_labels
        self.yy, self.xx = _iota(labels)
        ones = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
        acc = seg_sum_cols(torch.stack([ones, self.yy, self.xx], dim=-1), labels, max_labels)
        self.area = acc[..., 0]
        self.present = self.area > 0.5
        self.safe_area = self.area.clamp_min(1.0)
        self.cy = acc[..., 1] / self.safe_area
        self.cx = acc[..., 2] / self.safe_area

    def centered_coords(self):
        """(yy - cy[label], xx - cx[label]) per pixel (0 on background)."""
        fg = self.labels > 0
        c = table_lookup(torch.stack([self.cy, self.cx], dim=-1),
                         _label_index(self.labels, self.max_labels))
        zero = torch.zeros((), device=fg.device)
        return (torch.where(fg, self.yy - c[..., 0], zero),
                torch.where(fg, self.xx - c[..., 1], zero))

    def centered_scaled_coords(self):
        """Centered coords divided by sqrt(area): one 3-column lookup."""
        fg = self.labels > 0
        s = _sqrt(self.safe_area)
        c = table_lookup(torch.stack([self.cy, self.cx, s], dim=-1),
                         _label_index(self.labels, self.max_labels))
        zero = torch.zeros((), device=fg.device)
        return (torch.where(fg, (self.yy - c[..., 0]) / c[..., 2], zero),
                torch.where(fg, (self.xx - c[..., 1]) / c[..., 2], zero))

    def central_moments(self):
        """Second central moments (mu20, mu02, mu11) per label."""
        dy, dx = self.centered_coords()
        acc = seg_sum_cols(torch.stack([dy * dy, dx * dx, dy * dx], dim=-1),
                           self.labels, self.max_labels)
        return tuple(acc[..., i] / self.safe_area for i in range(3))


def ellipse_params(mu20, mu02, mu11, area):
    """skimage-convention ellipse from central moments:
    (major_axis_len, minor_axis_len, eccentricity, orientation)."""
    del area
    d = mu20 - mu02
    common = _sqrt((d * d + 4 * (mu11 * mu11)).clamp_min(0.0))
    l1 = _div(mu20 + mu02 + common, 2.0).clamp_min(0.0)
    l2 = _div(mu20 + mu02 - common, 2.0).clamp_min(0.0)
    major = 4 * _sqrt(l1)
    minor = 4 * _sqrt(l2)
    ecc = _sqrt((1.0 - l2 / l1.clamp_min(1e-12)).clamp_min(0.0))
    orientation = 0.5 * torch.atan2(-2 * mu11, mu02 - mu20)
    return major, minor, ecc, orientation


# ---------------------------------------------------------------------------
# Exact order statistics via one sort per image
# ---------------------------------------------------------------------------


def _sort_keys(labels: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """(B, N) int64 keys ordering (label, value) as ``lax.sort`` with two
    keys does: -0.0 equals +0.0, and NaNs sort by their sign bit to the
    ends."""
    v = torch.where(values == 0, torch.zeros((), device=values.device), values)
    return (labels.to(torch.int64) << 32) | _monotone_key(v)


def sorted_by_label(values: torch.Tensor, labels: torch.Tensor, max_labels: int):
    """Sort each image's pixels by (label, value), ties in pixel order.

    Returns ``(sorted_values (B, N), starts (B, L) int32, counts (B, L))``;
    ``starts[:, k]``/``counts[:, k]`` delimit label k+1's ascending run.
    Background (label 0) sorts first and is excluded by the offsets.
    """
    B = labels.shape[0]
    flat_l = labels.reshape(B, -1)
    flat_v = values.reshape(B, -1).to(torch.float32)
    _, order = torch.sort(_sort_keys(flat_l, flat_v), dim=-1, stable=True)
    sorted_v = torch.gather(flat_v, 1, order)
    cnt = counts(labels, max_labels)
    starts = _run_starts(cnt, flat_l.shape[1])
    return sorted_v, starts.to(torch.int32), cnt


def _run_starts(cnt: torch.Tensor, n: int) -> torch.Tensor:
    """f32 offsets of each label's run: the background count, then the
    running count of the labels before it."""
    n_bg = n - cnt.sum(dim=-1, keepdim=True)
    zero = torch.zeros_like(cnt[:, :1])
    return n_bg + torch.cat([zero, torch.cumsum(cnt, dim=-1)[:, :-1]], dim=-1)


def _take(sorted_v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(sorted_v, 1, idx.clamp(0, sorted_v.shape[1] - 1).to(torch.int64))


def quantile_from_sorted(sorted_v, starts, cnt, q: float):
    """Linear-interpolated quantile per label (numpy 'linear' method)."""
    pos = q * (cnt - 1.0).clamp_min(0.0)
    lo = torch.floor(pos).to(torch.int32)
    hi = torch.ceil(pos).to(torch.int32)
    frac = pos - lo
    v_lo = _take(sorted_v, starts + lo)
    v_hi = _take(sorted_v, starts + hi)
    out = v_lo * (1 - frac) + v_hi * frac
    return torch.where(cnt > 0, out, torch.full((), float("nan"), device=out.device))


def topk_mean_from_sorted(sorted_v, starts, cnt, frac: float):
    """Mean of the top ``frac`` fraction (at least one pixel) of each
    label's values (the reference's ``max2p5pc``: the top 2.5%), as a
    difference of one running sum over each image's sorted values."""
    csum = torch.cat([torch.zeros_like(sorted_v[:, :1]), cumsum_xla(sorted_v)], dim=1)
    k = torch.ceil(cnt * frac).clamp_min(1.0)
    k = torch.minimum(k, cnt).to(torch.int32)
    end = starts + cnt.to(torch.int32)
    top_sum = _take(csum, end) - _take(csum, end - k)
    out = top_sum / k.clamp_min(1).to(torch.float32)
    return torch.where(cnt > 0, out, torch.full((), float("nan"), device=out.device))


def topk_median_from_sorted(sorted_v, starts, cnt, k: int):
    """Median of each label's top ``k`` values."""
    kk = torch.clamp_max(cnt, float(k))
    end = starts + cnt.to(torch.int32)
    pos = (kk - 1.0) / 2.0
    lo = torch.floor(pos).to(torch.int32)
    hi = torch.ceil(pos).to(torch.int32)
    frac = pos - lo
    base = end - kk.to(torch.int32)
    out = _take(sorted_v, base + lo) * (1 - frac) + _take(sorted_v, base + hi) * frac
    return torch.where(cnt > 0, out, torch.full((), float("nan"), device=out.device))


def mad_from_sorted(sorted_v, starts, cnt, median):
    """Median absolute deviation per label, straight from the value sort.

    Within a label's ascending run, |v - m| is the merge of two ascending
    sequences (m - v over the values <= m read right to left, and v - m over
    the values > m), so its order statistics come from the two-sorted-arrays
    k-th-element bisection: 17 + 2 x 18 rounds of small per-label gathers.
    Float-exact against sorting |v - m| (``reductions.mad_from_sorted``).
    """
    n = cnt.to(torch.int32)
    m = torch.nan_to_num(median)
    starts = starts.to(torch.int32)
    inf = torch.full((), INF, device=m.device)

    lo = torch.zeros_like(n)
    hi = n
    for _ in range(17):  # nl = #values <= m per run
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        go_right = (mid < n) & (_take(sorted_v, starts + mid) <= m)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    nl = lo
    nr = n - nl

    def left(i):  # ascending: m - sorted_v[starts + nl - 1 - i]
        v = _take(sorted_v, starts + nl - 1 - i)
        return torch.where((i >= 0) & (i < nl), m - v, inf)

    def right(j):  # ascending: sorted_v[starts + nl + j] - m
        v = _take(sorted_v, starts + nl + j)
        return torch.where((j >= 0) & (j < nr), v - m, inf)

    def kth(k):  # 0-indexed k-th smallest of the merged sequences
        lo = (k + 1 - nr).clamp_min(0)
        hi = torch.minimum(k + 1, nl)
        for _ in range(18):
            mid = torch.div(lo + hi + 1, 2, rounding_mode="floor")
            q = torch.where(mid > 0, left(mid - 1), -inf) <= right(k + 1 - mid)
            lo = torch.where(q, mid, lo)
            hi = torch.where(q, hi, mid - 1)
        i = lo
        lv = torch.where(i > 0, left(i - 1), -inf)
        rv = torch.where(k - i >= 0, right(k - i), -inf)
        return torch.maximum(lv, rv)

    pos = 0.5 * (cnt - 1.0).clamp_min(0.0)
    k_lo = torch.floor(pos).to(torch.int32)
    k_hi = torch.ceil(pos).to(torch.int32)
    frac = pos - k_lo
    v_lo = kth(k_lo)
    v_hi = torch.where(k_hi == k_lo, v_lo, kth(k_hi))
    out = v_lo * (1 - frac) + v_hi * frac
    return torch.where(cnt > 0, out, torch.full((), float("nan"), device=out.device))


# ---------------------------------------------------------------------------
# Directional geometry: convex hull area, Feret diameters
# ---------------------------------------------------------------------------


def _directions(n_dir: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of the ``n_dir`` half-turn angles k*pi/n_dir, each taken
    in float64 from the f32 angle and rounded once to f32 (the same bits on
    every device; the reference's XLA:CPU f32 cos/sin differ from these in
    the last bit at a few angles)."""
    theta = (np.arange(n_dir, dtype=np.float32) * np.float32(math.pi / n_dir)).astype(np.float64)
    cos = torch.from_numpy(np.cos(theta).astype(np.float32)).to(device)
    sin = torch.from_numpy(np.sin(theta).astype(np.float32)).to(device)
    return cos, sin


def label_row_extents(labels: torch.Tensor, max_labels: int):
    """Per-(label, row) x-extent endpoints as dense (B, L, 2H) point arrays.

    Every convex-hull vertex of a label is extreme in x within its row, so
    this <= 2H-point set carries all support information. Two plain
    ``scatter_reduce_`` (amin/amax: the same bits on every run).

    Returns (py, px, valid), each (B, max_labels, 2H); invalid slots hold 0.
    """
    B, H, W = labels.shape
    dev = labels.device
    flat_l = labels.clamp(0, max_labels).reshape(B, -1).to(torch.int64)
    fg = (labels > 0).reshape(B, -1)
    yy = torch.arange(H, device=dev).repeat_interleave(W).expand(B, -1)
    xx = torch.arange(W, dtype=torch.float32, device=dev).repeat(H).expand(B, -1)
    bins = torch.where(fg, flat_l * H + yy, 0)
    NB = (max_labels + 1) * H
    inf = torch.full((), INF, device=dev)
    xmin = torch.full((B, NB), INF, device=dev).scatter_reduce_(
        1, bins, torch.where(fg, xx, inf), "amin")
    xmax = torch.full((B, NB), -INF, device=dev).scatter_reduce_(
        1, bins, torch.where(fg, xx, -inf), "amax")
    xmin = xmin.reshape(B, max_labels + 1, H)[:, 1:]
    xmax = xmax.reshape(B, max_labels + 1, H)[:, 1:]
    rows = torch.arange(H, dtype=torch.float32, device=dev).expand(B, max_labels, H)
    valid_row = torch.isfinite(xmin)
    px = torch.cat([xmin, xmax], dim=-1)
    py = torch.cat([rows, rows], dim=-1)
    vm = torch.cat([valid_row, valid_row], dim=-1)
    return py, torch.where(vm, px, torch.zeros((), device=dev)), vm


_DIR_CHUNK = 64  # directions per pass of directional_extents (bounds the temporaries)


def directional_extents(labels: torch.Tensor, max_labels: int, n_dir: int = 64):
    """Support-function extents per label over ``n_dir`` half-turn directions.

    Projections ``y*cos + x*sin`` are taken on the per-row endpoint set. The
    reference's (L, 2H, 2) x (2, K) product runs on XLA:CPU as
    ``fma(x, sin, round(y*cos))``; here that is reproduced exactly (the
    product rounded to f32, then the fused add taken in float64, which is
    exact for these pixel coordinates, and rounded once), so no matmul unit
    (and no TF32) is involved. Rounding to f32 is monotone, so the masked
    max/min is taken in float64 and rounded after.

    Returns (proj_max, proj_min), each (B, max_labels, n_dir).
    """
    cos, sin = _directions(n_dir, labels.device)
    py, px, vm = label_row_extents(labels, max_labels)
    py, px, vm = py.unsqueeze(-1), px.unsqueeze(-1).to(torch.float64), vm.unsqueeze(-1)
    pmax, pmin = [], []
    for k0 in range(0, n_dir, _DIR_CHUNK):
        c, s = cos[k0:k0 + _DIR_CHUNK], sin[k0:k0 + _DIR_CHUNK]
        proj = (py * c).to(torch.float64) + px * s.to(torch.float64)  # (B, L, 2H, k)
        pmax.append(torch.where(vm, proj, -INF).amax(dim=2))
        pmin.append(torch.where(vm, proj, INF).amin(dim=2))
    return torch.cat(pmax, -1).to(torch.float32), torch.cat(pmin, -1).to(torch.float32)


def feret_diameters(pmax: torch.Tensor, pmin: torch.Tensor):
    """(max_feret, min_feret) from directional extents (+1 px for pixel width)."""
    widths = pmax - pmin + 1.0
    finite = torch.isfinite(widths)
    max_f = torch.where(finite, widths, -INF).amax(dim=-1)
    min_f = torch.where(finite, widths, INF).amin(dim=-1)
    valid = finite.any(dim=-1)
    nan = torch.full((), float("nan"), device=widths.device)
    return torch.where(valid, max_f, nan), torch.where(valid, min_f, nan)


def convex_area_pixels(labels, max_labels: int, pmax=None, pmin=None, n_dir: int = 180):
    """Convex hull area per label in the pixel-count convention (skimage
    ``convex_image``.sum()): the hull is the intersection of the support
    slabs ``pmin <= <p, d_k> <= pmax``, solved for x per (label, row) and
    counted on the integer lattice (``reductions.convex_area_pixels``)."""
    B, H, W = labels.shape
    cos, sin = _directions(n_dir, labels.device)
    if pmax is None or pmin is None:
        pmax, pmin = directional_extents(labels, max_labels, n_dir=n_dir)
    eps = 1e-3
    is_axis = sin < 1e-9  # theta = 0: constrains y only
    sin_safe = torch.where(is_axis, torch.ones((), device=sin.device), sin)
    y = torch.arange(H, dtype=torch.float32, device=labels.device)
    ycos = y[None, None, :, None] * cos  # (1, 1, Y, K)
    lo = (pmin[:, :, None, :] - eps - ycos) / sin_safe  # (B, L, Y, K)
    hi = (pmax[:, :, None, :] + eps - ycos) / sin_safe
    xlo = torch.where(is_axis, -INF, lo).amax(dim=-1)  # (B, L, Y)
    xhi = torch.where(is_axis, INF, hi).amin(dim=-1)
    ok_axis = (ycos >= pmin[:, :, None, :] - eps) & (ycos <= pmax[:, :, None, :] + eps)
    yvalid = torch.where(is_axis, ok_axis, True).all(dim=-1)
    xlo_i = torch.ceil(xlo).clamp_min(0.0)
    xhi_i = torch.floor(xhi).clamp_max(W - 1.0)
    cnt = (xhi_i - xlo_i + 1.0).clamp_min(0.0)
    area = torch.where(yvalid, cnt, torch.zeros((), device=cnt.device)).sum(dim=-1)
    valid = torch.isfinite(pmax).all(dim=-1)
    return torch.where(valid, area, torch.full((), float("nan"), device=area.device))


def convex_area_from_extents(labels, max_labels: int, n_dir: int = 180):
    """The reference's backwards-compatible name of :func:`convex_area_pixels`."""
    return convex_area_pixels(labels, max_labels, n_dir=n_dir)


def minimum_enclosing_circle(labels: torch.Tensor, max_labels: int, bc_iters: int = 96,
                             top_k: int = 12):
    """Per-label minimum enclosing circle (cy, cx, r) of pixel centres, each
    (B, max_labels): the disk of the zernike families.

    As the reference: the candidates are the per-(label, row) x-extent
    endpoints; ``bc_iters`` Badoiu-Clarkson steps home in on the centre;
    two exact rounds take the ``top_k`` farthest endpoints, enumerate their
    pair and triple circumcircles and keep the smallest that encloses them;
    the radius is the largest distance from the chosen centre over all
    endpoints. Ties take the lowest index on every device (``argmax`` and
    ``argmin`` return the first extreme; the ``top_k`` farthest come from a
    stable descending sort), as ``jax.lax.top_k`` does.

    The search runs in float64, the reference's in f32. There a circle
    through integer points at coordinates near 100 misses its own points by
    ~1e-5 of r^2, the enclosure test allows 1e-6, and the exact rounds then
    reject the true circle and leave the approximate centre (a radius a few
    percent too large). In float64 the products of pixel coordinates are
    exact and the test holds. The centre is rounded to f32 once, and the
    radius is the f32 distance from that centre to the farthest endpoint,
    the same expression a caller evaluates per pixel, so that pixel sits at
    exactly r.

    Absent labels return meaningless rows: mask with ``counts() > 0``.
    """
    py32, px32, vm = label_row_extents(labels, max_labels)
    dev = labels.device
    neg_inf = torch.full((), -INF, device=dev)
    py32 = torch.where(vm, py32, torch.zeros((), device=dev))
    py, px = py32.to(torch.float64), px32.to(torch.float64)
    nv = vm.sum(dim=-1).clamp_min(1).to(torch.float64)
    cy = py.sum(dim=-1) / nv  # invalid slots hold 0
    cx = px.sum(dim=-1) / nv

    def masked_d2(cy, cx, py=py, px=px):
        dy, dx = py - cy.unsqueeze(-1), px - cx.unsqueeze(-1)
        return torch.where(vm, dy * dy + dx * dx, neg_inf.to(py.dtype))

    def take(a, idx):
        return torch.gather(a, -1, idx)

    for k in range(bc_iters):
        far = masked_d2(cy, cx).argmax(dim=-1, keepdim=True)
        cy = cy + (take(py, far)[..., 0] - cy) / (k + 2.0)
        cx = cx + (take(px, far)[..., 0] - cx) / (k + 2.0)

    pairs = torch.tensor(list(itertools.combinations(range(top_k), 2)), device=dev)
    tris = torch.tensor(list(itertools.combinations(range(top_k), 3)), device=dev)
    for _ in range(2):
        d2 = masked_d2(cy, cx)
        topv, topi = torch.sort(d2, dim=-1, descending=True, stable=True)
        topv, topi = topv[..., :top_k], topi[..., :top_k]
        ty, tx = take(py, topi), take(px, topi)  # (B, L, top_k)
        tval = topv > -INF
        # pair circles: centre = midpoint, r2 = a quarter of the pair's d2
        ay, ax, by, bx = ty[..., pairs[:, 0]], tx[..., pairs[:, 0]], ty[..., pairs[:, 1]], tx[..., pairs[:, 1]]
        pcy = (ay + by) / 2.0
        pcx = (ax + bx) / 2.0
        pr2 = ((ay - by) * (ay - by) + (ax - bx) * (ax - bx)) / 4.0
        pok = tval[..., pairs[:, 0]] & tval[..., pairs[:, 1]]
        # triple circumcircles
        t0y, t0x = ty[..., tris[:, 0]], tx[..., tris[:, 0]]
        t1y, t1x = ty[..., tris[:, 1]], tx[..., tris[:, 1]]
        t2y, t2x = ty[..., tris[:, 2]], tx[..., tris[:, 2]]
        d = 2.0 * (t0x * (t1y - t2y) + t1x * (t2y - t0y) + t2x * (t0y - t1y))
        s0 = t0x * t0x + t0y * t0y
        s1 = t1x * t1x + t1y * t1y
        s2 = t2x * t2x + t2y * t2y
        det_ok = d.abs() > 1e-9
        safe_d = torch.where(det_ok, d, torch.ones((), dtype=d.dtype, device=dev))
        ucx = (s0 * (t1y - t2y) + s1 * (t2y - t0y) + s2 * (t0y - t1y)) / safe_d
        ucy = (s0 * (t2x - t1x) + s1 * (t0x - t2x) + s2 * (t1x - t0x)) / safe_d
        tr2 = (t0y - ucy) * (t0y - ucy) + (t0x - ucx) * (t0x - ucx)
        tok = det_ok & tval[..., tris[:, 0]] & tval[..., tris[:, 1]] & tval[..., tris[:, 2]]
        ccy = torch.cat([pcy, ucy], dim=-1)  # (B, L, C)
        ccx = torch.cat([pcx, ucx], dim=-1)
        cr2 = torch.cat([pr2, tr2], dim=-1)
        cok = torch.cat([pok, tok], dim=-1)
        # validity: the circle encloses the top_k set (within fp tolerance)
        ey = ty.unsqueeze(-2) - ccy.unsqueeze(-1)
        ex = tx.unsqueeze(-2) - ccx.unsqueeze(-1)
        dd = torch.where(tval.unsqueeze(-2), ey * ey + ex * ex, neg_inf.to(ey.dtype))  # (B, L, C, top_k)
        encl = dd.amax(dim=-1) <= cr2 * (1.0 + 1e-6) + 1e-6
        score = torch.where(cok & encl, cr2, torch.full((), INF, dtype=cr2.dtype, device=dev))
        best = score.argmin(dim=-1, keepdim=True)
        has = torch.isfinite(take(score, best)[..., 0])
        cy = torch.where(has, take(ccy, best)[..., 0], cy)
        cx = torch.where(has, take(ccx, best)[..., 0], cx)

    cy, cx = cy.to(torch.float32), cx.to(torch.float32)
    r = _sqrt(masked_d2(cy, cx, py32, px32).amax(dim=-1).clamp_min(0.0))
    return cy, cx, r


# ---------------------------------------------------------------------------
# Boundary helpers
# ---------------------------------------------------------------------------


def _shifted(padded: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """The (B, H, W) window at offset (dy, dx) of a stack padded by 1."""
    H, W = padded.shape[-2] - 2, padded.shape[-1] - 2
    return padded[..., 1 + dy: 1 + dy + H, 1 + dx: 1 + dx + W]


def boundary_mask(labels: torch.Tensor, connectivity: int = 4) -> torch.Tensor:
    """Pixels whose neighbourhood leaves their label (object outlines):
    ``connectivity=4`` is the CellProfiler outline convention, 8 the
    skimage ``perimeter`` border."""
    pad = torch.nn.functional.pad(labels, (1, 1, 1, 1))
    offs = [(-1, 0), (1, 0), (0, -1), (0, 1)]
    if connectivity == 8:
        offs += [(-1, -1), (-1, 1), (1, -1), (1, 1)]
    diff = torch.zeros(labels.shape, dtype=torch.bool, device=labels.device)
    for dy, dx in offs:
        diff = diff | (labels != _shifted(pad, dy, dx))
    return diff & (labels > 0)


def distance_to_boundary(labels: torch.Tensor, max_iter: int = 64) -> torch.Tensor:
    """Chessboard distance inside each object of (B, H, W) labels, by
    ``max_iter`` same-label erosions: a pixel at distance d survives d of
    them (scipy ``distance_transform_cdt(metric="chessboard") + 1`` on each
    object alone: touching objects are each other's background)."""
    fg = labels > 0
    pad_l = torch.nn.functional.pad(labels, (1, 1, 1, 1), value=-1)
    offs = ((-1, 0), (1, 0), (0, -1), (0, 1), (-1, -1), (-1, 1), (1, -1), (1, 1))
    other = [_shifted(pad_l, dy, dx) != labels for dy, dx in offs]
    alive = fg
    dist = fg.to(torch.float32)
    for _ in range(max_iter):
        pad_a = torch.nn.functional.pad(alive, (1, 1, 1, 1))
        keep = alive
        for (dy, dx), o in zip(offs, other):
            keep = keep & (_shifted(pad_a, dy, dx) | o)
        dist = dist + keep.to(torch.float32)
        alive = keep
    return dist
