"""Plain mask reconstruction from a segmentation network's output, written
apart from the program: the hybrid Cellpose dynamics that the program
documents for its segmenters (``aliby_tpu/models/flows.py``), step by step
in plain PyTorch and SciPy, so that its labels can be compared pixel for
pixel.

1. Follow the flows: ``n_iter`` Euler steps (the first two by bilinear
   sampling inside a 4x4 window around the pixel, zero outside the image;
   later ones by clamped bilinear gathers), then each pixel's unit flow
   direction rounded to one of its 8 neighbours (flows under 0.02 stay) is
   followed for 96 steps, a pixel on a cycle of period <= 3 standing for
   the cycle's smallest index; a pixel's sink is the end of the path that
   starts at its rounded Euler position (within ``n_iter`` pixels).
2. Sinks into seeds: the sink histogram, seeds at 5x5 local maxima with a
   count above 10, ranked in raster order, grown for 5 rounds over the
   count > 2 corridor (a bin takes the neighbour of lowest (count, rank)).
3. QC: flows recomputed from the candidate masks (heat diffused 96 rounds
   from each object's centre, the pixel nearest its coordinate median,
   flows the unit gradient of log1p(heat)); an object whose mean squared
   flow error exceeds ``flow_threshold``, or smaller than ``min_size``, or
   over 40% of the image, is dropped; labels renumbered in order.
4. Holes: a 4-connected background region off the image border that
   borders exactly one object takes its label.

``dtype`` is the float type of every step (float32 as the configuration
states; bfloat16 for the output check's control).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage

OFFSETS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)]
N_PROP = 96  # steps along the rounded flow directions
N_HEAT = 96  # diffusion rounds of the QC's flows
BIG = 2 ** 30
NEAR = 1e-5  # QC errors this close to the threshold (relative) are undecided


def shift(x: torch.Tensor, dy: int, dx: int, fill=0) -> torch.Tensor:
    """out[..., y, x] = x[..., y + dy, x + dx]; ``fill`` outside the image."""
    H, W = x.shape[-2:]
    p = torch.nn.functional.pad(x, (1, 1, 1, 1), value=fill)
    return p[..., 1 + dy:H + 1 + dy, 1 + dx:W + 1 + dx]


def _at(field: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """field[y, x] for integer (H, W) maps, zero where (y, x) is outside."""
    H, W = field.shape
    ok = (y >= 0) & (y < H) & (x >= 0) & (x < W)
    v = field[y.clamp(0, H - 1), x.clamp(0, W - 1)]
    return torch.where(ok, v, torch.zeros((), dtype=field.dtype, device=field.device))


def follow_flows(flows: torch.Tensor, fg: torch.Tensor, n_iter: int,
                 dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """(2, H, W) flows, (H, W) foreground -> the (H, W) sink row and column
    of every pixel (background pixels are their own)."""
    _, H, W = flows.shape
    dev = flows.device
    fy, fx = flows[0].to(dtype), flows[1].to(dtype)
    yi = torch.arange(H, device=dev).reshape(H, 1).expand(H, W)
    xi = torch.arange(W, device=dev).reshape(1, W).expand(H, W)
    yy, xx = yi.to(dtype), xi.to(dtype)
    py = (yy + fy).clamp(0.0, H - 1.0)
    px = (xx + fx).clamp(0.0, W - 1.0)
    if n_iter >= 2:
        oy = (torch.floor(py) - yy).clamp(-1.0, 1.0).long()
        ox = (torch.floor(px) - xx).clamp(-1.0, 1.0).long()
        ty, tx = py - torch.floor(py), px - torch.floor(px)

        def window(field):
            def v(ay, ax):
                return _at(field, yi + oy + ay, xi + ox + ax)
            return (v(0, 0) * (1 - ty) * (1 - tx) + v(0, 1) * (1 - ty) * tx
                    + v(1, 0) * ty * (1 - tx) + v(1, 1) * ty * tx)

        py, px = (py + window(fy)).clamp(0.0, H - 1.0), (px + window(fx)).clamp(0.0, W - 1.0)
    for _ in range(n_iter - 2):
        cy, cx = py.clamp(0.0, H - 1.0), px.clamp(0.0, W - 1.0)
        # integer indices clamped after the conversion: in bfloat16, H - 1
        # itself may round up to H
        y0, x0 = torch.floor(cy).long().clamp(0, H - 1), torch.floor(cx).long().clamp(0, W - 1)
        y1, x1 = (y0 + 1).clamp_max(H - 1), (x0 + 1).clamp_max(W - 1)
        wy, wx = cy - y0.to(dtype), cx - x0.to(dtype)

        def gather(field):
            return (field[y0, x0] * (1 - wy) * (1 - wx) + field[y0, x1] * (1 - wy) * wx
                    + field[y1, x0] * wy * (1 - wx) + field[y1, x1] * wy * wx)

        py, px = py + gather(fy), px + gather(fx)

    # one step along the rounded unit direction of the flow
    fmag = torch.sqrt(fy * fy + fx * fx)
    finv = torch.where(fmag > 0.02, 1 / fmag.clamp_min(1e-20), torch.zeros((), dtype=dtype,
                                                                              device=dev))
    ty1 = torch.round((yy + fy * finv).clamp(0.0, H - 1.0)).long().clamp(0, H - 1)
    tx1 = torch.round((xx + fx * finv).clamp(0.0, W - 1.0)).long().clamp(0, W - 1)
    dy1, dx1 = (ty1 - yi).clamp(-1, 1), (tx1 - xi).clamp(-1, 1)
    # cycles of period <= 3 start from their smallest index
    o2y = dy1 + _at(dy1, yi + dy1, xi + dx1)
    o2x = dx1 + _at(dx1, yi + dy1, xi + dx1)
    o3y = o2y + _at(dy1, yi + o2y, xi + o2x)
    o3x = o2x + _at(dx1, yi + o2y, xi + o2x)
    idx0 = yi * W + xi
    id1 = (yi + dy1) * W + (xi + dx1)
    id2 = (yi + o2y) * W + (xi + o2x)
    on1 = (dy1 == 0) & (dx1 == 0)
    on2 = (o2y == 0) & (o2x == 0) & ~on1
    on3 = (o3y == 0) & (o3x == 0) & ~on1 & ~on2
    key0 = torch.where(on2, torch.minimum(idx0, id1), idx0)
    key0 = torch.where(on3, torch.minimum(idx0, torch.minimum(id1, id2)), key0)
    # the key at the end of N_PROP steps: the successor map raised to the
    # power N_PROP by repeated squaring
    succ, power = id1.reshape(-1), torch.arange(H * W, device=dev)
    n = N_PROP
    while n:
        if n & 1:
            power = succ[power]
        succ = succ[succ]
        n >>= 1
    key = key0.reshape(-1)[power].reshape(H, W)
    ry = torch.round(py).long().clamp(0, H - 1)
    rx = torch.round(px).long().clamp(0, W - 1)
    if n_iter <= 2:
        r = max(n_iter, 1)
        final = _at(key, yi + (ry - yi).clamp(-r, r), xi + (rx - xi).clamp(-r, r))
    else:
        final = key[ry, rx]
    sy = torch.where(fg, torch.div(final, W, rounding_mode="floor"), yi)
    sx = torch.where(fg, torch.remainder(final, W), xi)
    return sy, sx


def seeds_from_sinks(sy: torch.Tensor, sx: torch.Tensor, fg: torch.Tensor,
                     max_labels: int) -> torch.Tensor:
    """Sinks -> (H, W) seed ranks (0: none; ranks past ``max_labels`` are
    dropped)."""
    H, W = fg.shape
    dev = fg.device
    sink = (sy * W + sx).reshape(-1)
    hist = torch.zeros(H * W, dtype=torch.int64, device=dev)
    hist.index_add_(0, sink[fg.reshape(-1)], torch.ones(int(fg.sum()), dtype=torch.int64,
                                                        device=dev))
    hist = hist.reshape(H, W)
    hmax = hist
    for _ in range(2):
        hmax = torch.maximum(hmax, torch.maximum(shift(hmax, 1, 0), shift(hmax, -1, 0)))
    for _ in range(2):
        hmax = torch.maximum(hmax, torch.maximum(shift(hmax, 0, 1), shift(hmax, 0, -1)))
    seeds = (hist >= hmax) & (hist > 10)
    rank = torch.cumsum(seeds.reshape(-1).long(), 0).reshape(H, W)
    corridor = hist > 2
    big = torch.full((), BIG, dtype=torch.int64, device=dev)
    kh, ki = torch.where(seeds, hist, big), torch.where(seeds, rank, big)

    def lexmin(kh, ki, pairs):
        nh, ni = kh, ki
        for dy, dx in pairs:
            sh, si = shift(kh, dy, dx, BIG), shift(ki, dy, dx, BIG)
            better = (sh < nh) | ((sh == nh) & (si < ni))
            nh, ni = torch.where(better, sh, nh), torch.where(better, si, ni)
        return nh, ni

    for _ in range(5):
        nh, ni = lexmin(kh, ki, ((-1, 0), (1, 0)))
        nh, ni = lexmin(nh, ni, ((0, -1), (0, 1)))
        kh, ki = torch.where(corridor, nh, big), torch.where(corridor, ni, big)
    owner = torch.where(ki < BIG, ki, 0).reshape(-1)
    raw = torch.where(fg.reshape(-1), owner[sink], 0)
    return torch.where(raw <= max_labels, raw, 0).reshape(H, W)


def median_centres(labels: np.ndarray) -> np.ndarray:
    """(H, W) labels -> bool map of each object's centre: the object pixel
    nearest (2y, 2x) = (lower + upper median) of its rows and columns,
    ties to the first in raster order."""
    H, W = labels.shape
    flat = labels.reshape(-1)
    order = np.argsort(flat, kind="stable")
    sorted_l = flat[order]
    starts = np.searchsorted(sorted_l, np.arange(1, sorted_l.max(initial=0) + 2))
    out = np.zeros(H * W, bool)
    for lab in range(1, len(starts)):
        pos = order[starts[lab - 1]:starts[lab]]
        if not len(pos):
            continue
        ys, xs = pos // W, pos % W
        n = len(pos)

        def twice_median(c):
            s = np.sort(c)
            return int(s[(n + 1) // 2 - 1] + s[n // 2])

        d2 = (2 * ys - twice_median(ys)) ** 2 + (2 * xs - twice_median(xs)) ** 2
        out[pos[np.flatnonzero(d2 == d2.min())].min()] = True
    return out.reshape(H, W)


def flows_from_masks(labels: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(H, W) labels -> (2, H, W) unit flows towards each object's centre."""
    dev = labels.device
    fg = labels > 0
    src = torch.from_numpy(median_centres(labels.cpu().numpy())).to(dev, dtype)
    same = {o: (shift(labels, *o, -1) == labels).to(dtype) for o in OFFSETS}
    zero = torch.zeros((), dtype=dtype, device=dev)
    nine = torch.full((), 9.0, dtype=dtype, device=dev)  # a true division on every device
    T = torch.zeros(labels.shape, dtype=dtype, device=dev)
    for _ in range(N_HEAT):
        T = T + src
        acc = T
        for o in OFFSETS:
            acc = acc + shift(T, *o) * same[o]
        T = torch.where(fg, torch.div(acc, nine), zero)
    logT = torch.log1p(T)

    def grad(dy, dx):
        return (shift(logT, dy, dx) * same[(dy, dx)] - shift(logT, -dy, -dx) * same[(-dy, -dx)]) / 2

    gy, gx = grad(1, 0), grad(0, 1)
    den = torch.sqrt(gy * gy + gx * gx).clamp_min(1e-20)
    return torch.stack([torch.where(fg, gy / den, zero), torch.where(fg, gx / den, zero)])


def fill_holes(labels: np.ndarray) -> np.ndarray:
    """Each 4-connected background region off the image border that borders
    exactly one object takes that object's label."""
    comp, n = ndimage.label(labels == 0)
    if n == 0:
        return labels
    H, W = labels.shape
    touches = np.zeros(n + 1, bool)
    touches[np.unique(np.concatenate([comp[0], comp[-1], comp[:, 0], comp[:, -1]]))] = True
    lo = np.full(n + 1, np.iinfo(np.int64).max)
    hi = np.zeros(n + 1, np.int64)
    pad_c = np.pad(comp, 1)
    pad_l = np.pad(labels.astype(np.int64), 1)
    for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        c = pad_c[1:H + 1, 1:W + 1]
        nb = pad_l[1 + dy:H + 1 + dy, 1 + dx:W + 1 + dx]
        sel = (c > 0) & (nb > 0)
        np.minimum.at(lo, c[sel], nb[sel])
        np.maximum.at(hi, c[sel], nb[sel])
    fill = (~touches) & (lo == hi) & (hi > 0)
    fill[0] = False
    return np.where(fill[comp], lo[comp] * fill[comp], labels).astype(labels.dtype)


def masks_from_output(pred: torch.Tensor, n_iter: int, max_labels: int = 256,
                      min_size: int = 15, flow_threshold: float | None = 0.4,
                      cellprob_threshold: float = 0.0, dtype=torch.float32):
    """A network's (3, H, W) output (flow_y, flow_x, cell logit, flows 5x
    scaled) -> ((H, W) int32 labels, (H, W) bool map of the pixels of the
    candidate objects whose QC error lies within ``NEAR`` of the threshold,
    kept or dropped: a computation in float32 may decide them the other
    way)."""
    H, W = pred.shape[-2:]
    five = torch.full((), 5.0, dtype=pred.dtype, device=pred.device)
    flows = torch.div(pred[:2], five).to(dtype)  # a true division on every device
    fg = pred[2] > cellprob_threshold
    sy, sx = follow_flows(flows, fg, n_iter, dtype)
    raw = seeds_from_sinks(sy, sx, fg, max_labels)
    idx = raw.reshape(-1)
    cnts = torch.zeros(max_labels + 1, dtype=torch.float64, device=raw.device)
    cnts.index_add_(0, idx, torch.ones(H * W, dtype=torch.float64, device=raw.device))
    drop = cnts < min_size
    near = torch.zeros_like(drop)
    if flow_threshold is not None:
        d = flows_from_masks(raw, dtype) - flows
        err_px = (d[0] * d[0] + d[1] * d[1]).reshape(-1).double()
        sums = torch.zeros(max_labels + 1, dtype=torch.float64, device=raw.device)
        sums.index_add_(0, idx, err_px)
        err = sums / cnts.clamp_min(1.0)
        drop = drop | (err > flow_threshold)
        # a float32 mean over a few thousand pixels in another order may
        # land on the other side of the threshold
        near = (err - flow_threshold).abs() <= NEAR * flow_threshold
    drop = drop | (cnts > 0.4 * H * W)
    present = (cnts >= 1) & ~drop
    present[0] = False
    table = torch.where(present, torch.cumsum(present.long(), 0), 0)
    labels = fill_holes(table[idx].reshape(H, W).cpu().numpy().astype(np.int32))
    return labels, near[idx].reshape(H, W).cpu().numpy()


def canonical(labels: np.ndarray) -> np.ndarray:
    """Labels renumbered 1..n in the raster order of each object's first
    pixel: two label maps of one partition become equal."""
    ids, first = np.unique(labels.ravel(), return_index=True)
    keep = ids > 0
    table = np.zeros(int(ids.max(initial=0)) + 1, np.int64)
    table[ids[keep][np.argsort(first[keep])]] = np.arange(1, keep.sum() + 1)
    return table[labels]
