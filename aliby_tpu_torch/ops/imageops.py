"""Image primitives (counterpart of ``aliby_tpu/ops/imageops.py``),
batched over a leading axis: images are ``(B, H, W)``.

- Exact order statistics and percentiles. Rows are the last axis; order
  statistics are taken over the monotone uint32 encoding of IEEE-754 f32
  (held in int64), so the result is the exact array element the
  reference's bit-bisection selects: -0.0 keys below +0.0, and a NaN
  selects as +huge.
- The threshold segmenter's filters: :func:`histogram`,
  :func:`otsu_threshold`, :func:`gaussian_blur`, :func:`max_filter`,
  :func:`peak_local_max`.
- Trap detection's filters: binary morphology, :func:`clear_border`,
  :func:`entropy_filter`, FFT correlation and :func:`match_template`,
  :func:`resize_bilinear`.
- Phase correlation (on the device, and the tiler's host form) and
  :func:`downscale_mean`.

Floating-point work is spelled as elementwise operations in a fixed order
(no library reduction decides an order), so the CPU and the card give the
same bits. Against the reference: histograms, Otsu's cumulative sums
(:func:`cumsum_xla`, the reference backend's blocked order), max filters,
morphology and peak picking are exact; the Gaussian blur's taps sum in
another order than XLA's convolution (within rtol 1e-6), and FFTs, ``log2``
and the resize's contraction differ in the last bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

_SIGN = 0x80000000
_MASK = 0xFFFFFFFF


def _monotone_key(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int64 key in [0, 2^32) with the reference's total order."""
    u = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & _MASK
    return torch.where(u >= _SIGN, (~u) & _MASK, u | _SIGN)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root on every device, as the reference's
    (XLA) and the card's are. PyTorch's CPU f32 ``sqrt`` is off by one ulp
    on about 0.7% of inputs (sqrt(267) among them), so the CPU takes it in
    float64 and rounds once (exact: 53 >= 2 * 24 + 2 bits)."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.to(torch.float64)).to(torch.float32)
    return torch.sqrt(x)


def _key_to_f32(k: torch.Tensor) -> torch.Tensor:
    u = torch.where(k >= _SIGN, k ^ _SIGN, (~k) & _MASK)
    u = torch.where(u >= _SIGN, u - (1 << 32), u)  # two's complement int32
    return u.to(torch.int32).view(torch.float32)


def order_statistics(x: torch.Tensor, ranks: tuple[int, ...]) -> torch.Tensor:
    """Exact 0-indexed order statistics of each row: (..., n) f32 ->
    (..., len(ranks)) f32, bit-equal to the reference's selection."""
    keys, _ = torch.sort(_monotone_key(x), dim=-1)
    idx = torch.as_tensor(ranks, dtype=torch.int64, device=x.device)
    return _key_to_f32(keys.index_select(-1, idx))


def percentile_pair(x: torch.Tensor, q_lo: float, q_hi: float):
    """(lo, hi) linearly interpolated percentiles of each row of (..., n).

    NumPy's convention as the reference spells it: float64 index arithmetic
    ``q/100*(n-1)`` on the host, then an f32 lerp ``a + (b-a)*t``."""
    n = int(x.shape[-1])
    idx = [float(q) / 100.0 * (n - 1) for q in (q_lo, q_hi)]
    lo_r = [int(np.floor(i)) for i in idx]
    hi_r = [int(np.ceil(i)) for i in idx]
    t = [float(np.float32(i - np.floor(i))) for i in idx]
    vals = order_statistics(x, (lo_r[0], hi_r[0], lo_r[1], hi_r[1]))
    out_lo = vals[..., 0] + (vals[..., 1] - vals[..., 0]) * t[0]
    out_hi = vals[..., 2] + (vals[..., 3] - vals[..., 2]) * t[1]
    return out_lo, out_hi


def phase_cross_correlation_host(reference: np.ndarray, moving: np.ndarray) -> np.ndarray:
    """Host (numpy) pixel-precision phase correlation: the (dy, dx) shift
    registering ``moving`` to ``reference`` (skimage's
    ``phase_cross_correlation`` at ``upsample_factor=1``). The drift tracker
    calls it once per (position, timepoint) on one frame pair, a few-ms FFT
    that the host does while the device computes."""
    A = np.fft.rfft2(np.asarray(reference, np.float32))
    B = np.fft.rfft2(np.asarray(moving, np.float32))
    corr = np.fft.irfft2(A * np.conj(B), s=reference.shape)
    idx = int(np.argmax(np.abs(corr)))
    H, W = reference.shape
    dy, dx = idx // W, idx % W
    if dy > H // 2:
        dy -= H
    if dx > W // 2:
        dx -= W
    return np.array([dy, dx], np.float32)


def phase_cross_correlation(reference: torch.Tensor, moving: torch.Tensor,
                            upsample_factor: int = 1) -> torch.Tensor:
    """Shift (dy, dx) registering each ``moving`` image to its ``reference``
    on their device, (..., H, W) -> (..., 2) f32 (the reference's
    ``phase_cross_correlation``): the first maximum of the magnitude of the
    inverse FFT of the cross-power spectrum, wrapped to signed shifts; with
    ``upsample_factor > 1``, a parabolic refinement around that peak, at
    most one pixel an axis."""
    H, W = reference.shape[-2:]
    fa = torch.fft.fft2(reference.to(torch.float32))
    fb = torch.fft.fft2(moving.to(torch.float32))
    mag = torch.fft.ifft2(fa * fb.conj()).abs().reshape(*reference.shape[:-2], H * W)
    idx = _argmax_first(mag)
    dy = idx // W
    dx = idx % W
    dy = torch.where(dy > H // 2, dy - H, dy)
    dx = torch.where(dx > W // 2, dx - W, dx)
    shift = torch.stack([dy, dx], -1).to(torch.float32)
    if upsample_factor <= 1:
        return shift

    def at(y, x):
        return mag.gather(-1, ((y % H) * W + x % W).unsqueeze(-1)).squeeze(-1)

    c = at(dy, dx)

    def refine(d, plus, minus):
        denom = plus - 2 * c + minus
        frac = torch.where(denom.abs() > 1e-9, (minus - plus) / (2 * denom), 0.0)
        return d + frac.clamp(-1, 1)

    return torch.stack([refine(shift[..., 0], at(dy + 1, dx), at(dy - 1, dx)),
                        refine(shift[..., 1], at(dy, dx + 1), at(dy, dx - 1))], -1)


def downscale_mean(img: torch.Tensor, factor: int) -> torch.Tensor:
    """Integer-factor mean pooling of (..., H, W) images (the reference's
    ``downscale_mean``): rows and columns past the last whole block are
    dropped; each block's f32 sum is taken in the reference backend's
    order (row by row, left to right) and multiplied by the f32 reciprocal
    of ``factor ** 2``, as XLA computes the mean: the same bits."""
    H, W = img.shape[-2:]
    Hc, Wc = (H // factor) * factor, (W // factor) * factor
    x = img[..., :Hc, :Wc].to(torch.float32)
    x = x.reshape(*img.shape[:-2], Hc // factor, factor, Wc // factor, factor)
    acc = torch.zeros_like(x[..., 0, :, 0])
    for j in range(factor):
        for k in range(factor):
            acc = acc + x[..., j, :, k]
    return acc * float(np.float32(1.0 / (factor * factor)))


# ---------------------------------------------------------------------------
# Cumulative sums, histograms, Otsu
# ---------------------------------------------------------------------------

_SCAN_BLOCK = 16


def cumsum_xla(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum over the last axis in the reference
    backend's order: XLA rewrites ``jnp.cumsum`` into blocks of 16 summed in
    sequence, the block totals scanned the same way (recursively), and each
    block's exclusive carry added to its running sums. Elementwise adds
    only, so every device gives these bits."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    if n <= _SCAN_BLOCK:
        cols = [x[..., 0]]
        for i in range(1, n):
            cols.append(cols[-1] + x[..., i])
        return torch.stack(cols, dim=-1) if cols else x
    m = -(-n // _SCAN_BLOCK)
    pad = m * _SCAN_BLOCK - n
    xp = torch.cat([x, x.new_zeros(lead + (pad,))], dim=-1) if pad else x
    rows = cumsum_xla(xp.reshape(lead + (m, _SCAN_BLOCK)))
    tot = cumsum_xla(rows[..., -1].contiguous())
    carry = torch.cat([tot.new_zeros(lead + (1,)), tot[..., :-1]], dim=-1)
    return (rows + carry.unsqueeze(-1)).reshape(lead + (m * _SCAN_BLOCK,))[..., :n]


def _quantize(x: torch.Tensor, vmin: torch.Tensor, span: torch.Tensor, bins: int) -> torch.Tensor:
    """``clip(int32((x - vmin) / span * bins), 0, bins - 1)``: truncation
    toward zero, then the clip (a NaN gives bin 0, as XLA's conversion)."""
    v = (x - vmin) / span * float(bins)
    return torch.nan_to_num(v, nan=0.0).clamp(0, bins - 1).to(torch.int32)


def histogram(img: torch.Tensor, bins: int = 256):
    """Per image of (B, ...): ``(counts (B, bins) int32, edges (B, bins + 1))``
    over [min, max] (the reference's ``histogram`` with vmin/vmax unset)."""
    B = img.shape[0]
    flat = img.reshape(B, -1).to(torch.float32)
    vmin = flat.amin(dim=1, keepdim=True)
    vmax = flat.amax(dim=1, keepdim=True)
    span = torch.clamp_min(vmax - vmin, 1e-12)
    idx = _quantize(flat, vmin, span, bins)
    counts = torch.zeros(B, bins, dtype=torch.int32, device=img.device)
    counts.scatter_add_(1, idx.to(torch.int64), torch.ones_like(idx))
    steps = torch.arange(bins + 1, dtype=torch.float32, device=img.device)
    edges = vmin + steps * span / float(bins)
    return counts, edges


def otsu_threshold(img: torch.Tensor, bins: int = 256) -> torch.Tensor:
    """Between-class-variance-maximising threshold of each image of (B, ...)
    -> (B,) f32 (skimage-compatible, the reference's arithmetic)."""
    counts, edges = histogram(img, bins)
    centers = (edges[:, :-1] + edges[:, 1:]) * 0.5
    w = counts.to(torch.float32)
    p = w / torch.clamp_min(w.sum(dim=1, keepdim=True), 1.0)
    omega0 = cumsum_xla(p)
    mu_part = cumsum_xla(p * centers)
    mu_total = mu_part[:, -1:]
    omega1 = 1.0 - omega0
    mu0 = mu_part / torch.clamp_min(omega0, 1e-12)
    mu1 = (mu_total - mu_part) / torch.clamp_min(omega1, 1e-12)
    d = mu0 - mu1
    sigma_b = omega0 * omega1 * (d * d)
    sigma_b = torch.where((omega0 > 0) & (omega1 > 0), sigma_b,
                          torch.full((), -1.0, device=img.device))
    best = _argmax_first(sigma_b)
    return torch.gather(centers, 1, best.unsqueeze(1))[:, 0]


def _argmax_first(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum of each row (``jnp.argmax``)."""
    n = x.shape[-1]
    is_max = x == x.amax(dim=-1, keepdim=True)
    idx = torch.arange(n, device=x.device).expand_as(x)
    return torch.where(is_max, idx, n).amin(dim=-1)


# ---------------------------------------------------------------------------
# Separable / neighbourhood filters
# ---------------------------------------------------------------------------


def gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """The normalised Gaussian taps (f32, computed on the host)."""
    radius = max(int(truncate * sigma + 0.5), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(np.float32(-0.5) * (x / np.float32(sigma)) ** 2).astype(np.float32)
    return (k / k.sum(dtype=np.float32)).astype(np.float32)


def _correlate_valid(x: torch.Tensor, k: np.ndarray, dim: int) -> torch.Tensor:
    """'valid' correlation of ``x`` with taps ``k`` along ``dim``: the
    taps' products summed in tap order."""
    n = x.shape[dim] - len(k) + 1
    acc = None
    for j, kj in enumerate(k):
        term = x.narrow(dim, j, n) * torch.tensor(float(kj), dtype=torch.float32,
                                                   device=x.device)
        acc = term if acc is None else acc + term
    return acc


def _pad_symmetric(x: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """Half-sample symmetric padding (scipy's "reflect", numpy's
    "symmetric") by ``r`` on both sides of ``dim``."""
    n = x.shape[dim]
    idx = torch.arange(-r, n + r, device=x.device)
    period = 2 * n
    idx = torch.remainder(idx, period)
    idx = torch.where(idx >= n, period - 1 - idx, idx)
    return x.index_select(dim, idx)


def gaussian_blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian of each (B, H, W) image, reflect padding (rows,
    then columns, as the reference)."""
    k = gaussian_kernel1d(sigma)
    r = (len(k) - 1) // 2
    x = _pad_symmetric(img.to(torch.float32), r, 1)
    x = _correlate_valid(x, k, 1)
    x = _pad_symmetric(x, r, 2)
    return _correlate_valid(x, k, 2)


def _sliding_max(x: torch.Tensor, size: int, dim: int, fill: float) -> torch.Tensor:
    """Max over a centred window of odd ``size`` along ``dim`` (SAME
    padding with ``fill``), by doubling: exact, O(log size) passes."""
    r = size // 2
    n = x.shape[dim]
    pad_shape = list(x.shape)
    pad_shape[dim] = r
    pad = torch.full(pad_shape, fill, dtype=x.dtype, device=x.device)
    m = torch.cat([pad, x, pad], dim=dim)  # length n + 2r; window i covers [i, i + size)
    width = 1
    while width * 2 <= size:
        L = m.shape[dim] - width
        m = torch.maximum(m.narrow(dim, 0, L), m.narrow(dim, width, L))
        width *= 2
    # m[i] = max over [i, i + width); cover [i, i + size) by two such runs
    return torch.maximum(m.narrow(dim, 0, n), m.narrow(dim, size - width, n))


def max_filter(img: torch.Tensor, size: int = 3) -> torch.Tensor:
    """Max over a ``size`` x ``size`` window of each (B, H, W) image (SAME
    padding with the dtype's lowest value, as ``reduce_window``)."""
    fill = -math.inf if img.is_floating_point() else torch.iinfo(img.dtype).min
    return _window_max(img, size, fill)


def _window_max(img: torch.Tensor, size: int, fill) -> torch.Tensor:
    return _sliding_max(_sliding_max(img, size, 1, fill), size, 2, fill)


def _shift(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """``out[y, x] = x[y + dy, x + dx]`` with ``fill`` outside, per image
    of (B, H, W)."""
    B, H, W = x.shape
    out = torch.full_like(x, fill)
    ys, yd = slice(max(dy, 0), H + min(dy, 0)), slice(max(-dy, 0), H + min(-dy, 0))
    xs, xd = slice(max(dx, 0), W + min(dx, 0)), slice(max(-dx, 0), W + min(-dx, 0))
    out[:, yd, xd] = x[:, ys, xs]
    return out


def binary_dilation(mask: torch.Tensor, n_iter: int = 1, connectivity: int = 1) -> torch.Tensor:
    """``n_iter`` dilations of each (B, H, W) mask by the cross
    (connectivity 1) or the 3 x 3 square (2); outside the image is False."""
    m = mask.to(torch.bool)
    for _ in range(n_iter):
        if connectivity == 2:
            m = _window_max(m.to(torch.uint8), 3, 0) > 0
        else:
            grown = m.clone()
            for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
                grown |= _shift(m, dy, dx, False)
            m = grown
    return m


def binary_erosion(mask: torch.Tensor, n_iter: int = 1, connectivity: int = 1) -> torch.Tensor:
    return ~binary_dilation(~mask.to(torch.bool), n_iter=n_iter, connectivity=connectivity)


def binary_closing(mask: torch.Tensor, size: int = 2) -> torch.Tensor:
    return binary_erosion(binary_dilation(mask, size, 2), size, 2)


def clear_border(labels: torch.Tensor) -> torch.Tensor:
    """Zero every label of each (B, H, W) map that touches the border
    (skimage semantics). Ids may be raw connected-component ids (up to
    H * W), so the presence table has H * W + 1 bins."""
    B, H, W = labels.shape
    n_bins = H * W + 1
    border = torch.zeros(H, W, dtype=torch.bool, device=labels.device)
    border[0, :] = border[-1, :] = True
    border[:, 0] = border[:, -1] = True
    idx = labels.clamp(0, n_bins - 1).reshape(B, -1).to(torch.int64)
    touched = torch.zeros(B, n_bins, dtype=torch.bool, device=labels.device)
    touched.scatter_(1, torch.where(border.reshape(1, -1), idx, 0), True)
    touched[:, 0] = False
    hit = torch.gather(touched, 1, idx).reshape(labels.shape)
    return torch.where(hit, torch.zeros_like(labels), labels)


def entropy_filter(img: torch.Tensor, radius: int = 3, bins: int = 32) -> torch.Tensor:
    """Local Shannon entropy (bits) of each (B, H, W) image over a disk of
    ``radius`` (skimage.filters.rank.entropy on ``bins`` grey levels).

    The disk's per-level counts are integers: each of its rows is a
    horizontal run, taken as a difference of exact integer prefix sums."""
    B, H, W = img.shape
    img = img.to(torch.float32)
    flat = img.reshape(B, -1)
    vmin = flat.amin(dim=1).reshape(B, 1, 1)
    vmax = flat.amax(dim=1).reshape(B, 1, 1)
    q = _quantize(img, vmin, torch.clamp_min(vmax - vmin, 1e-12), bins)
    onehot = (q.unsqueeze(1) == torch.arange(bins, device=img.device).reshape(1, bins, 1, 1))
    padded = F.pad(onehot.to(torch.int32), (radius + 1, radius, radius, radius))
    prefix = torch.cumsum(padded, dim=3, dtype=torch.int32)  # (B, bins, H + 2r, W + 2r + 1)
    counts = torch.zeros(B, bins, H, W, dtype=torch.int32, device=img.device)
    for dy in range(-radius, radius + 1):
        h = math.isqrt(radius * radius - dy * dy)
        rows = prefix[:, :, radius + dy: radius + dy + H]
        # columns x - h .. x + h of the unpadded row: prefix[x + h + r + 1] - prefix[x - h + r]
        counts += rows[..., radius + h + 1: radius + h + 1 + W] - rows[..., radius - h: radius - h + W]
    c = counts.to(torch.float32)
    total = c.sum(dim=1, keepdim=True)
    p = c / torch.clamp_min(total, 1.0)
    terms = p * torch.log2(torch.clamp_min(p, 1e-12))
    ent = terms[:, 0]
    for b in range(1, bins):
        ent = ent + terms[:, b]
    return -ent


# ---------------------------------------------------------------------------
# FFT correlation, template matching, resizing
# ---------------------------------------------------------------------------


def fft_correlate_same(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """'same'-mode cross-correlation of each (B, H, W) image with one (h, w)
    kernel through the real FFT (f32)."""
    B, H, W = img.shape
    h, w = kernel.shape
    fh, fw = H + h - 1, W + w - 1
    Fi = torch.fft.rfft2(img.to(torch.float32), s=(fh, fw))
    Fk = torch.fft.rfft2(torch.flip(kernel.to(torch.float32), (0, 1)), s=(fh, fw))
    full = torch.fft.irfft2(Fi * Fk, s=(fh, fw))
    y0, x0 = (h - 1) // 2, (w - 1) // 2
    return full[:, y0:y0 + H, x0:x0 + W]


def match_template(img: torch.Tensor, template: torch.Tensor) -> torch.Tensor:
    """Normalised cross-correlation of each (B, H, W) image with one
    template, 'same' output in [-1, 1] (skimage ``pad_input=True``)."""
    img = img.to(torch.float32)
    t = template.to(torch.float32)
    n = float(t.numel())
    t0 = t - t.mean()
    t_ss = torch.clamp_min((t0 * t0).sum(), 1e-12)
    ones = torch.ones_like(t)
    num = fft_correlate_same(img, t0)
    s1 = fft_correlate_same(img, ones)
    s2 = fft_correlate_same(img * img, ones)
    win_var = torch.clamp_min(s2 - s1 * s1 / torch.tensor(n, device=img.device), 0.0)
    denom = _sqrt(win_var * t_ss)
    return (num / torch.clamp_min(denom, 1e-8)) * (denom > 1e-8)


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) f32 weights of ``jax.image.resize(...,
    "bilinear")`` along one axis: a triangle kernel widened by the inverse
    scale when downscaling (antialiasing), columns normalised, samples
    outside the input zeroed (``jax._src.image.scale.compute_weight_mat``)."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.0) - f32(0.5)
    # XLA divides by the constant kernel scale as a multiply by its reciprocal
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) \
        * (f32(1.0) / kernel_scale)
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0)).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= f32(in_size - 0.5))
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _resize_axis(x: torch.Tensor, out_size: int, dim: int) -> torch.Tensor:
    """Contract ``dim`` of ``x`` with :func:`resize_weights`: each output
    sample sums its non-zero taps in input order."""
    n = x.shape[dim]
    if n == out_size:
        return x
    w = resize_weights(n, out_size)
    taps = max(int((w != 0).sum(axis=0).max()), 1)
    idx = np.zeros((taps, out_size), np.int64)
    wt = np.zeros((taps, out_size), np.float32)
    for j in range(out_size):
        nz = np.flatnonzero(w[:, j])
        idx[: len(nz), j] = nz
        idx[len(nz):, j] = nz[-1] if len(nz) else 0
        wt[: len(nz), j] = w[nz, j]
    shape = [1] * x.dim()
    shape[dim] = out_size
    acc = None
    for t in range(taps):
        col = x.index_select(dim, torch.from_numpy(idx[t]).to(x.device))
        term = col * torch.from_numpy(wt[t]).to(x.device).reshape(shape)
        acc = term if acc is None else acc + term
    return acc


def resize_bilinear(img: torch.Tensor, out_shape: tuple[int, int]) -> torch.Tensor:
    """``jax.image.resize(img, out_shape, "bilinear")`` of each (B, H, W)
    image, antialiased when it downscales (``F.interpolate`` without
    ``antialias=True`` is another function)."""
    x = _resize_axis(img.to(torch.float32), int(out_shape[0]), 1)
    return _resize_axis(x, int(out_shape[1]), 2)


def peak_local_max(img: torch.Tensor, min_distance: int, threshold, max_peaks: int = 512):
    """Local maxima of each (B, H, W) image at least ``min_distance`` apart
    (a (2 md + 1)^2 max filter) and above ``threshold`` (a number or a (B,)
    tensor). Returns ``(coords (B, max_peaks, 2) int32, valid (B,
    max_peaks) bool)``, ranked by value and, among equal values, by flat
    index (``jax.lax.top_k``'s order: a stable descending sort)."""
    B, H, W = img.shape
    size = 2 * min_distance + 1
    thr = threshold if isinstance(threshold, torch.Tensor) else torch.tensor(
        float(threshold), dtype=img.dtype, device=img.device)
    thr = thr.reshape(-1, 1, 1) if thr.dim() else thr
    local_max = (img >= max_filter(img, size)) & (img > thr)
    score = torch.where(local_max, img, torch.full((), -math.inf, dtype=img.dtype,
                                                    device=img.device)).reshape(B, -1)
    k = min(max_peaks, score.shape[1])
    vals, order = torch.sort(score, dim=1, descending=True, stable=True)
    vals, order = vals[:, :k], order[:, :k]
    if k < max_peaks:  # fewer pixels than peaks: pad as invalid
        vals = torch.cat([vals, vals.new_full((B, max_peaks - k), -math.inf)], dim=1)
        order = torch.cat([order, order.new_zeros((B, max_peaks - k))], dim=1)
    coords = torch.stack([order // W, order % W], dim=-1).to(torch.int32)
    return coords, vals > -math.inf
