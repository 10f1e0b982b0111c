"""Flow-field dynamics and mask reconstruction (counterpart of
``aliby_tpu/models/flows.py``), batched: every function takes a leading
image axis B where the reference is vmapped.

- :func:`masks_to_flows`: heat diffusion from each object's median centre,
  flows = the unit gradient of log1p(heat) (the QC recomputation).
- :func:`follow_flows`: 2 Euler steps by stencil selects, then successor-map
  key propagation with the canonical-cycle key init.
- :func:`masks_from_sinks`, :func:`fill_label_holes`, :func:`masks_from_flows`:
  histogram seeds, corridor expansion, flow-error QC, compaction and hole
  filling, in the reference's stage order.

The two long stencil loops run through :mod:`aliby_tpu_torch.ops.stencil`
and the QC sums through :func:`aliby_tpu_torch.extract.reductions.binned_sum_cols`;
each is a CUDA kernel on the GPU. Float operations keep the reference's
order, and every division is a true division (never a multiply by a
reciprocal), so the CPU path reproduces the JAX package bit for bit where
the JAX package is exact.
"""

from __future__ import annotations

import torch

from aliby_tpu_torch.extract.reductions import binned_sum_cols
from aliby_tpu_torch.ops.imageops import _sqrt
from aliby_tpu_torch.ops.labels import relabel_dense
from aliby_tpu_torch.ops.stencil import OFFSETS, diffuse_heat, shift, successor_prop
from aliby_tpu_torch.utils.profiling import span

BIG_I32 = 2**30
I32_MAX = 2**31 - 1


def _div(a: torch.Tensor, b: float | torch.Tensor) -> torch.Tensor:
    """a / b as an IEEE division on every device (a CPU scalar divisor
    becomes a multiply by its reciprocal in PyTorch's CUDA kernels)."""
    if not isinstance(b, torch.Tensor):
        b = torch.full((), b, dtype=a.dtype, device=a.device)
    return torch.div(a, b)


def _iota(B: int, H: int, W: int, dtype, device):
    yy = torch.arange(H, dtype=dtype, device=device).reshape(1, H, 1).expand(B, H, W)
    xx = torch.arange(W, dtype=dtype, device=device).reshape(1, 1, W).expand(B, H, W)
    return yy, xx


def label_median_centers(labels: torch.Tensor, max_labels: int = 512) -> torch.Tensor:
    """(B, H, W) labels -> (B, H, W) bool map of each object's centre pixel:
    the object pixel nearest its coordinate median (ties -> first in raster
    order), with the reference's packed fast path for H*W <= 2^16."""
    B, H, W = labels.shape
    dev = labels.device
    L1 = max_labels + 1
    lc = labels.clamp(0, max_labels).to(torch.int64)
    fg = labels > 0
    yy, xx = _iota(B, H, W, torch.int64, dev)
    bidx = torch.arange(B, device=dev).reshape(B, 1, 1)

    def coord_median(coord, size):
        # per-label coordinate histogram (B, L+1, size), fg pixels only
        # (background pixels land on one spare slot past the end)
        idx = torch.where(fg, (bidx * L1 + lc) * size + coord, B * L1 * size)
        hist = torch.zeros(B * L1 * size + 1, dtype=torch.int32, device=dev)
        hist.index_add_(0, idx.reshape(-1), fg.reshape(-1).to(torch.int32))
        cum = torch.cumsum(hist[:-1].reshape(B, L1, size), dim=2, dtype=torch.int32)
        n = cum[..., -1:]
        k_lo = torch.div(n + 1, 2, rounding_mode="floor")
        k_hi = torch.div(n, 2, rounding_mode="floor") + 1
        lo = torch.argmax((cum >= k_lo).to(torch.uint8), dim=2)
        hi = torch.argmax((cum >= k_hi).to(torch.uint8), dim=2)
        return lo + hi  # (B, L+1) 2*median, exact

    ymed2 = coord_median(yy, H)
    xmed2 = coord_median(xx, W)
    flat_l = lc.reshape(B, -1)
    fgf = fg.reshape(B, -1)
    pos = torch.arange(H * W, dtype=torch.int64, device=dev).expand(B, H * W)
    lab_idx = torch.where(fgf, flat_l, 0)
    ym = torch.gather(ymed2, 1, flat_l)
    xm = torch.gather(xmed2, 1, flat_l)
    dy = 2 * yy.reshape(B, -1) - ym
    dx = 2 * xx.reshape(B, -1) - xm
    if H * W <= (1 << 16) and H <= (1 << 15) and W <= (1 << 15):
        # packed one-scatter path: (d2 capped at 2^15 - 2) << 16 | pos
        d2i = torch.clamp_max(dy * dy + dx * dx, (1 << 15) - 2)
        key = torch.where(fgf, (d2i << 16) | pos, I32_MAX)
        best = torch.full((B, L1), I32_MAX, dtype=torch.int64, device=dev)
        best.scatter_reduce_(1, lab_idx, key, "amin")
        valid = best[:, 1:] < I32_MAX
        center_pos = torch.where(valid, best[:, 1:] & 0xFFFF, 0)
    else:
        # exact two-pass path: nearest distance, then first raster position
        d2i = dy * dy + dx * dx
        best_d2 = torch.full((B, L1), I32_MAX, dtype=torch.int64, device=dev)
        best_d2.scatter_reduce_(1, lab_idx, torch.where(fgf, d2i, I32_MAX), "amin")
        at_best = fgf & (d2i == torch.gather(best_d2, 1, flat_l))
        best = torch.full((B, L1), I32_MAX, dtype=torch.int64, device=dev)
        best.scatter_reduce_(1, torch.where(at_best, flat_l, 0),
                             torch.where(at_best, pos, I32_MAX), "amin")
        valid = best[:, 1:] < I32_MAX
        center_pos = torch.where(valid, best[:, 1:], 0)
    centers = torch.zeros(B, H * W, dtype=torch.uint8, device=dev)
    centers.scatter_reduce_(1, torch.where(valid, center_pos, H * W - 1),
                            valid.to(torch.uint8), "amax")
    return centers.reshape(B, H, W).bool()


def masks_to_flows(labels: torch.Tensor, n_iter: int = 96, max_labels: int = 512) -> torch.Tensor:
    """(B, H, W) labels -> (B, 2, H, W) unit flows pointing at object centres
    (cellpose's heat-diffusion training target, whole-image form)."""
    labels = labels.to(torch.int32)
    fg = labels > 0
    source = label_median_centers(labels, max_labels).to(torch.float32)
    same = [(shift(labels, dy, dx, -1) == labels).to(torch.float32) for dy, dx in OFFSETS]
    T = diffuse_heat(labels, source, n_iter)
    logT = torch.log1p(T)

    def grad_axis(dy, dx):
        plus = shift(logT, dy, dx) * same[OFFSETS.index((dy, dx))]
        minus = shift(logT, -dy, -dx) * same[OFFSETS.index((-dy, -dx))]
        return _div(plus - minus, 2.0)

    gy = grad_axis(1, 0)
    gx = grad_axis(0, 1)
    mag = _sqrt(gy * gy + gx * gx)
    den = torch.clamp_min(mag, 1e-20)
    zero = torch.zeros((), device=labels.device)
    gy = torch.where(fg, _div(gy, den), zero)
    gx = torch.where(fg, _div(gx, den), zero)
    return torch.stack([gy, gx], dim=1)


def _bilinear(field: torch.Tensor, py: torch.Tensor, px: torch.Tensor) -> torch.Tensor:
    """Sample (B, C, H, W) fields at (B, P) float positions; clamped borders."""
    B, C, H, W = field.shape
    py = py.clamp(0.0, H - 1.0)
    px = px.clamp(0.0, W - 1.0)
    y0 = torch.floor(py).to(torch.int64)
    x0 = torch.floor(px).to(torch.int64)
    y1 = torch.clamp_max(y0 + 1, H - 1)
    x1 = torch.clamp_max(x0 + 1, W - 1)
    fy = (py - y0).unsqueeze(1)
    fx = (px - x0).unsqueeze(1)
    flat = field.reshape(B, C, H * W)

    def at(y, x):
        return torch.gather(flat, 2, (y * W + x).unsqueeze(1).expand(B, C, -1))

    return (
        at(y0, x0) * (1 - fy) * (1 - fx)
        + at(y0, x1) * (1 - fy) * fx
        + at(y1, x0) * fy * (1 - fx)
        + at(y1, x1) * fy * fx
    )


def _sel_wide(field: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor, r: int) -> torch.Tensor:
    """field sampled at p + (oy, ox), |oy|, |ox| <= r, zero outside the grid."""
    H, W = field.shape[-2:]
    fp = torch.nn.functional.pad(field, (r, r, r, r))
    out = torch.zeros_like(field)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            sel = (oy == dy) & (ox == dx)
            out = torch.where(sel, fp[..., r + dy : H + r + dy, r + dx : W + r + dx], out)
    return out


def follow_flows(flows: torch.Tensor, fg: torch.Tensor, n_iter: int = 2,
                 n_prop: int = 96) -> torch.Tensor:
    """Integrate pixels along (B, 2, H, W) flows; returns (B, 2, H, W) final
    positions (the reference's hybrid Euler + successor-propagation scheme)."""
    B, _, H, W = flows.shape
    dev = flows.device
    yy, xx = _iota(B, H, W, torch.float32, dev)
    fy, fx = flows[:, 0], flows[:, 1]
    py = (yy + fy).clamp(0.0, H - 1.0) if n_iter >= 1 else yy
    px = (xx + fx).clamp(0.0, W - 1.0) if n_iter >= 1 else xx

    if n_iter >= 2:
        # Euler step 2: bilinear at p1 by stencil selects over the 4x4 window
        oy = (torch.floor(py) - yy).clamp(-1.0, 1.0).to(torch.int32)
        ox = (torch.floor(px) - xx).clamp(-1.0, 1.0).to(torch.int32)
        ty = py - torch.floor(py)
        tx = px - torch.floor(px)

        def sample(field):
            fp = torch.nn.functional.pad(field, (2, 2, 2, 2))
            vals = {
                (dy, dx): fp[:, 2 + dy : H + 2 + dy, 2 + dx : W + 2 + dx]
                for dy in (-1, 0, 1, 2)
                for dx in (-1, 0, 1, 2)
            }

            def pick(ay, ax):
                out = torch.zeros_like(field)
                for dy in (-1, 0, 1):
                    for dx in (-1, 0, 1):
                        sel = (oy == dy) & (ox == dx)
                        out = torch.where(sel, vals[(dy + ay, dx + ax)], out)
                return out

            return (
                pick(0, 0) * (1 - ty) * (1 - tx)
                + pick(0, 1) * (1 - ty) * tx
                + pick(1, 0) * ty * (1 - tx)
                + pick(1, 1) * ty * tx
            )

        py = (py + sample(fy)).clamp(0.0, H - 1.0)
        px = (px + sample(fx)).clamp(0.0, W - 1.0)

    if n_iter > 2:  # ported-checkpoint schedule: true bilinear gathers
        pyf, pxf = py.reshape(B, -1), px.reshape(B, -1)
        for _ in range(n_iter - 2):
            v = _bilinear(flows, pyf, pxf)
            pyf, pxf = pyf + v[:, 0], pxf + v[:, 1]
        py, px = pyf.reshape(B, H, W), pxf.reshape(B, H, W)

    if n_prop > 0:
        yi, xi = _iota(B, H, W, torch.int32, dev)
        fmag = _sqrt(fy * fy + fx * fx)
        zero = torch.zeros((), device=dev)
        finv = torch.where(fmag > 0.02, _div(torch.ones_like(fmag), torch.clamp_min(fmag, 1e-20)),
                           zero)
        uy, ux = fy * finv, fx * finv
        dy1 = (torch.round((yy + uy).clamp(0.0, H - 1.0)).to(torch.int32) - yi).clamp(-1, 1)
        dx1 = (torch.round((xx + ux).clamp(0.0, W - 1.0)).to(torch.int32) - xi).clamp(-1, 1)
        dcode = ((dy1 + 1) * 3 + (dx1 + 1)).to(torch.int32)

        # canonical-cycle key init: pixels on a successor cycle of period
        # <= 3 start from the cycle's smallest index (offsets composed by
        # stencil selects: o2 = o1 + o1(p + o1), o3 = o2 + o1(p + o2))
        s1y = _sel_wide(dy1, dy1, dx1, 1)
        s1x = _sel_wide(dx1, dy1, dx1, 1)
        o2y, o2x = dy1 + s1y, dx1 + s1x
        s2y = _sel_wide(dy1, o2y, o2x, 2)
        s2x = _sel_wide(dx1, o2y, o2x, 2)
        o3y, o3x = o2y + s2y, o2x + s2x
        idx0 = yi * W + xi
        id1 = (yi + dy1) * W + (xi + dx1)
        id2 = (yi + o2y) * W + (xi + o2x)
        on1 = (dy1 == 0) & (dx1 == 0)
        on2 = (o2y == 0) & (o2x == 0) & ~on1
        on3 = (o3y == 0) & (o3x == 0) & ~on1 & ~on2
        canon = torch.where(on2, torch.minimum(idx0, id1), idx0)
        canon = torch.where(on3, torch.minimum(idx0, torch.minimum(id1, id2)), canon)

        key = successor_prop(dcode, canon.to(torch.int32), n_prop=n_prop, block=6)
        ry = torch.round(py).clamp(0, H - 1).to(torch.int32)
        rx = torch.round(px).clamp(0, W - 1).to(torch.int32)
        if n_iter <= 2:
            final = _sel_wide(key, (ry - yi).clamp(-n_iter, n_iter),
                              (rx - xi).clamp(-n_iter, n_iter), max(n_iter, 1))
        else:
            final = torch.gather(key.reshape(B, -1), 1,
                                 (ry * W + rx).reshape(B, -1).to(torch.int64)).reshape(B, H, W)
        py = torch.div(final, W, rounding_mode="floor").to(torch.float32)
        px = torch.remainder(final, W).to(torch.float32)

    py = torch.where(fg, py, yy)
    px = torch.where(fg, px, xx)
    return torch.stack([py, px], dim=1)


def masks_from_sinks(final_pos: torch.Tensor, fg: torch.Tensor, max_labels: int = 256,
                     drop_megamasks: bool = True) -> torch.Tensor:
    """Cluster converged (B, 2, H, W) positions into (B, H, W) int32 labels:
    sink histogram, 5x5 local-max seeds with count > 10, 5 rounds of
    lexicographic (count, seed rank) expansion over the count > 2 corridor.

    ``drop_megamasks=False`` returns dense seed ranks (possibly with gaps);
    ``True`` also drops masks over 40% of the image and relabels 1..n."""
    B, H, W = fg.shape
    HW = H * W
    dev = fg.device
    sy = torch.round(final_pos[:, 0]).to(torch.int32).clamp(0, H - 1)
    sx = torch.round(final_pos[:, 1]).to(torch.int32).clamp(0, W - 1)
    sink = (sy * W + sx).reshape(B, -1).to(torch.int64)
    fgf = fg.reshape(B, -1)
    bidx = torch.arange(B, device=dev).reshape(B, 1) * HW
    hist = torch.zeros(B * HW + 1, dtype=torch.int32, device=dev)  # + spare slot
    hist.index_add_(0, torch.where(fgf, sink + bidx, B * HW).reshape(-1),
                    fgf.reshape(-1).to(torch.int32))
    hist = hist[:-1].reshape(B, H, W)

    hmax = hist
    for _ in range(2):
        hmax = torch.maximum(hmax, torch.maximum(shift(hmax, 1, 0), shift(hmax, -1, 0)))
    for _ in range(2):
        hmax = torch.maximum(hmax, torch.maximum(shift(hmax, 0, 1), shift(hmax, 0, -1)))
    seeds = (hist >= hmax) & (hist > 10)

    rank2d = torch.cumsum(seeds.reshape(B, -1).to(torch.int32), dim=1,
                          dtype=torch.int32).reshape(B, H, W)
    corridor = hist > 2
    big = torch.full((), BIG_I32, dtype=torch.int32, device=dev)
    key_h = torch.where(seeds, hist, big)
    key_i = torch.where(seeds, rank2d, big)

    def lexmin3(kh, ki, pairs):
        nh, ni = kh, ki
        for dy, dx in pairs:
            sh = shift(kh, dy, dx, BIG_I32)
            si = shift(ki, dy, dx, BIG_I32)
            better = (sh < nh) | ((sh == nh) & (si < ni))
            nh = torch.where(better, sh, nh)
            ni = torch.where(better, si, ni)
        return nh, ni

    for _ in range(5):
        nh, ni = lexmin3(key_h, key_i, ((-1, 0), (1, 0)))
        nh, ni = lexmin3(nh, ni, ((0, -1), (0, 1)))
        key_h = torch.where(corridor, nh, big)
        key_i = torch.where(corridor, ni, big)

    owner = torch.where(key_i < BIG_I32, key_i, 0).reshape(B, -1)
    raw = torch.where(fgf, torch.gather(owner, 1, sink), 0)
    raw = torch.where(raw <= max_labels, raw, 0)
    if drop_megamasks:
        areas = torch.zeros(B, max_labels + 1, dtype=torch.float32, device=dev)
        areas.scatter_add_(1, raw.to(torch.int64), torch.ones_like(raw, dtype=torch.float32))
        keep = (torch.gather(areas, 1, raw.to(torch.int64)) <= 0.4 * HW) & (raw > 0)
        raw = torch.where(keep, raw, 0)
        return relabel_dense(raw.reshape(B, H, W), max_labels + 1, max_labels)
    return raw.reshape(B, H, W).to(torch.int32)


def fill_label_holes(labels: torch.Tensor) -> torch.Tensor:
    """Fill enclosed background holes per mask: a 4-connected background
    component that does not touch the border and borders exactly one label
    takes that label. (B, H, W) int32 -> (B, H, W) int32.

    Component-wide (min, max) adjacent labels propagate by 4-neighbour
    stencil rounds over the non-border-visible background until stable;
    the host checks for convergence every 8 rounds."""
    B, H, W = labels.shape
    dev = labels.device
    bg = labels == 0
    blocked = (~bg).to(torch.int32)
    vis = (
        (torch.cumsum(blocked, dim=1) == 0)
        | (torch.cumsum(blocked.flip(1), dim=1).flip(1) == 0)
        | (torch.cumsum(blocked, dim=2) == 0)
        | (torch.cumsum(blocked.flip(2), dim=2).flip(2) == 0)
    ) & bg
    rest = bg & ~vis
    big = torch.full((), BIG_I32, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    pmin = torch.full((B, H, W), BIG_I32, dtype=torch.int32, device=dev)
    pmax = torch.zeros((B, H, W), dtype=torch.int32, device=dev)
    four = ((-1, 0), (1, 0), (0, -1), (0, 1))
    for dy, dx in four:
        nb = shift(labels, dy, dx, 0)
        nvis = shift(vis, dy, dx, False)
        pmin = torch.minimum(pmin, torch.where(nb > 0, nb, big))
        pmax = torch.maximum(pmax, torch.where(nvis, big, nb))
    border = torch.zeros((H, W), dtype=torch.bool, device=dev)
    border[0, :] = True
    border[-1, :] = True
    border[:, 0] = True
    border[:, -1] = True
    pmax = torch.where(border, big, pmax)
    pmin = torch.where(rest, pmin, big)
    pmax = torch.where(rest, pmax, zero)
    nrest = [shift(rest, dy, dx, False) for dy, dx in four]

    def one_round(pmin, pmax):
        nmin, nmax = pmin, pmax
        for (dy, dx), nr in zip(four, nrest):
            nmin = torch.minimum(nmin, torch.where(nr, shift(pmin, dy, dx, BIG_I32), big))
            nmax = torch.maximum(nmax, torch.where(nr, shift(pmax, dy, dx, 0), zero))
        return torch.where(rest, nmin, big), torch.where(rest, nmax, zero)

    for _ in range(H * W):
        nmin, nmax = pmin, pmax
        for _ in range(8):
            nmin, nmax = one_round(nmin, nmax)
        changed = bool(((nmin != pmin) | (nmax != pmax)).any())
        pmin, pmax = nmin, nmax
        if not changed:
            break
    fillable = rest & (pmin == pmax) & (pmin > 0) & (pmax < BIG_I32)
    return torch.where(fillable, pmin, labels)


def masks_from_flows(flows: torch.Tensor, cellprob: torch.Tensor,
                     cellprob_threshold: float = 0.0, n_iter: int = 2,
                     max_labels: int = 256, min_size: int = 15,
                     flow_threshold: float | None = None,
                     fill_holes: bool = True) -> torch.Tensor:
    """(B, 2, H, W) flows + (B, H, W) cell logits -> (B, H, W) int32 labels.

    Cellpose ``compute_masks`` stage order: follow flows -> sink clustering
    -> optional flow-error QC (drop masks whose recomputed flows differ from
    the predicted ones by mean squared error > ``flow_threshold``) ->
    min-size and >40%-of-image drops -> compaction -> hole filling."""
    B, _, H, W = flows.shape
    with span("seg.dynamics", device=flows.device):
        fg = cellprob > cellprob_threshold
        final = follow_flows(flows, fg, n_iter=n_iter)
        labels = masks_from_sinks(final, fg, max_labels=max_labels, drop_megamasks=False)
    with span("seg.qc", device=flows.device):
        l_idx = (labels - 1).clamp(0, max_labels - 1).to(torch.int64).reshape(B, -1)
        lab_px = torch.where(labels > 0, labels, 0).reshape(B, -1)
        bins = lab_px.clamp(0, max_labels)
        inside = (lab_px > 0).to(torch.float32)
        if flow_threshold is not None:
            mask_flows = masks_to_flows(labels, max_labels=max_labels)
            d = mask_flows - flows
            err_px = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]).reshape(B, -1)
            zero = torch.zeros((), device=flows.device)
            cols = torch.stack([torch.where(lab_px > 0, err_px, zero), inside], dim=-1)
            acc = binned_sum_cols(cols, bins, max_labels + 1)
            sums, cnts = acc[:, 1:, 0], acc[:, 1:, 1]
            err = _div(sums, torch.clamp_min(cnts, 1.0))
            drop = (err > flow_threshold) | (cnts < min_size)
        else:
            cnts = binned_sum_cols(inside[..., None], bins, max_labels + 1)[:, 1:, 0]
            drop = cnts < min_size
        drop = drop | (cnts > 0.4 * H * W)
        present = (cnts >= 1.0) & ~drop
        seq = torch.cumsum(present.to(torch.int32), dim=1, dtype=torch.int32)
        table = torch.where(present, seq, 0).to(torch.int32)
        labels = torch.where(labels.reshape(B, -1) > 0, torch.gather(table, 1, l_idx), 0)
        labels = labels.reshape(B, H, W).to(torch.int32)
        if fill_holes:
            labels = fill_label_holes(labels)
        return labels
