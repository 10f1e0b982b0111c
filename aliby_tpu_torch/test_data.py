"""Synthetic fields, numpy only (copies of ``aliby_tpu/test_data.render_cells``
and of the bench's five-channel Cell Painting field builder), so the port
and ``chip_smoke.py`` can make inputs without JAX."""

from __future__ import annotations

import numpy as np


def render_cells(
    size: int,
    n_cells: int,
    rng: np.random.Generator,
    nucleus_frac: float = 0.45,
    with_nucleus_labels: bool = False,
) -> tuple[np.ndarray, ...]:
    """Return (cell_intensity, nucleus_intensity, label_map) for one field.

    Cells are rotated ellipses placed without heavy overlap; intensities have
    a soft interior profile. With ``with_nucleus_labels`` a fourth array is
    appended: the per-nucleus label map (same ids as the cell labels).
    """
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    cells = np.zeros((size, size), np.float32)
    nuclei = np.zeros((size, size), np.float32)
    labels = np.zeros((size, size), np.int32)
    nuc_labels = np.zeros((size, size), np.int32)
    centers = []
    placed = 0
    attempts = 0
    margin = min(18, max(4, size // 4))
    while placed < n_cells and attempts < n_cells * 30:
        attempts += 1
        cy, cx = rng.uniform(margin, size - margin, 2)
        if centers and np.min(
            np.hypot(np.array(centers)[:, 0] - cy, np.array(centers)[:, 1] - cx)
        ) < 26:
            continue
        a = rng.uniform(8, 14)
        b = rng.uniform(6, 11)
        theta = rng.uniform(0, np.pi)
        ct, st = np.cos(theta), np.sin(theta)
        u = (xx - cx) * ct + (yy - cy) * st
        v = -(xx - cx) * st + (yy - cy) * ct
        d2 = (u / a) ** 2 + (v / b) ** 2
        inside = d2 <= 1.0
        if not inside.any():
            continue
        placed += 1
        centers.append((cy, cx))
        profile = np.clip(1.2 - d2, 0, None).astype(np.float32)
        cells = np.maximum(cells, profile * rng.uniform(0.6, 1.0))
        labels[inside & (labels == 0)] = placed
        nd2 = (u / (a * nucleus_frac)) ** 2 + (v / (b * nucleus_frac)) ** 2
        nprofile = np.clip(1.2 - nd2, 0, None).astype(np.float32)
        nuclei = np.maximum(nuclei, nprofile * rng.uniform(0.7, 1.0))
        nuc_labels[(nd2 <= 1.0) & (nuc_labels == 0)] = placed
    if with_nucleus_labels:
        return cells, nuclei, labels, nuc_labels
    return cells, nuclei, labels


def cellpainting_fields(n_fovs: int, size: int = 256, seed: int = 7,
                        n_cells: int = 24) -> list[np.ndarray]:
    """The bench's five-channel Cell Painting fields: a list of
    (F=1, C=5, Z=1, Y, X) f32 stacks (DNA, ER, RNA, AGP, Mito)."""
    rng = np.random.default_rng(seed)
    fovs = []
    for _ in range(n_fovs):
        cells, nuclei, _ = render_cells(size, n_cells, rng)
        noise = lambda: rng.normal(0.02, 0.01, (size, size)).astype(np.float32)  # noqa: E731
        ring = np.clip(cells - nuclei, 0, None)
        stack = np.stack(
            [nuclei + noise(), ring + noise(), 0.5 * nuclei + 0.5 * cells + noise(),
             cells + noise(), ring * 0.8 + noise()]
        )  # (5, Y, X)
        fovs.append(stack[None, :, None])
    return fovs


def cellpainting_large_field(size: int = 1080, seed: int = 11) -> np.ndarray:
    """One (1, 5, 1, size, size) field at the bench fields' cell density:
    256x256 bench fields laid out edge to edge and cropped (a 1080x1080
    field is the size of a JUMP Cell Painting image)."""
    n = -(-size // 256)
    tiles = [f[0, :, 0] for f in cellpainting_fields(n * n, 256, seed=seed)]
    rows = [np.concatenate(tiles[r * n : (r + 1) * n], axis=-1) for r in range(n)]
    return np.concatenate(rows, axis=-2)[None, :, None, :size, :size]


def _render_ellipse(img: np.ndarray, cy: float, cx: float, a: float, b: float,
                    theta: float, amp: float) -> None:
    """``img = max(img, amp * clip(1.2 - d2, 0))`` for the ellipse (a, b,
    theta) at (cy, cx), evaluated on its bounding box only."""
    H, W = img.shape
    r = int(np.ceil(max(a, b) * 1.1)) + 1
    y0, y1 = max(int(cy) - r, 0), min(int(cy) + r + 1, H)
    x0, x1 = max(int(cx) - r, 0), min(int(cx) + r + 1, W)
    if y1 <= y0 or x1 <= x0:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1].astype(np.float32)
    ct, st = np.cos(theta), np.sin(theta)
    u = (xx - cx) * ct + (yy - cy) * st
    v = -(xx - cx) * st + (yy - cy) * ct
    d2 = (u / a) ** 2 + (v / b) ** 2
    prof = np.clip(1.2 - d2, 0, None).astype(np.float32) * amp
    np.maximum(img[y0:y1, x0:x1], prof, out=img[y0:y1, x0:x1])


def cellpainting_movie(n_pos: int, ntps: int, size: int = 1080, seed: int = 13,
                       n_cells: int | None = None, nucleus_frac: float = 0.45) -> np.ndarray:
    """Time-lapse five-channel Cell Painting fields, (n_pos, ntps, C=5, Z=1,
    size, size) uint16 (the fields' [0, ~1.3] intensities times 4096).

    Each position holds ``n_cells`` cells (by default the bench fields'
    density, 24 per 256x256: about 420 at 1080x1080) placed as
    :func:`render_cells` places them. Every cell drifts by its own velocity
    of up to 2 px a timepoint in each axis; about 5% of the cells appear
    after the first timepoint and 5% disappear before the last. The channels
    are those of :func:`cellpainting_fields`, with fresh noise each frame.
    """
    rng = np.random.default_rng(seed)
    if n_cells is None:
        n_cells = max(1, round(24 * size * size / 256 ** 2))
    margin = min(18, max(4, size // 4))
    out = np.empty((n_pos, ntps, 5, 1, size, size), np.uint16)
    for p in range(n_pos):
        centers = np.zeros((0, 2))
        attempts = 0
        while len(centers) < n_cells and attempts < n_cells * 30:
            attempts += 1
            c = rng.uniform(margin, size - margin, 2)
            if len(centers) and np.min(np.hypot(*(centers - c).T)) < 26:
                continue
            centers = np.vstack([centers, c])
        n = len(centers)
        a = rng.uniform(8, 14, n)
        b = rng.uniform(6, 11, n)
        theta = rng.uniform(0, np.pi, n)
        amp_c = rng.uniform(0.6, 1.0, n)
        amp_n = rng.uniform(0.7, 1.0, n)
        vel = rng.uniform(-2, 2, (n, 2))
        born = np.where(rng.random(n) < 0.05, rng.integers(1, max(ntps, 2), n), 0)
        dies = np.where(rng.random(n) < 0.05, rng.integers(1, max(ntps, 2), n), ntps)
        for t in range(ntps):
            cells = np.zeros((size, size), np.float32)
            nuclei = np.zeros((size, size), np.float32)
            for i in np.flatnonzero((born <= t) & (t < dies)):
                cy, cx = centers[i] + t * vel[i]
                _render_ellipse(cells, cy, cx, a[i], b[i], theta[i], amp_c[i])
                _render_ellipse(nuclei, cy, cx, a[i] * nucleus_frac, b[i] * nucleus_frac,
                                theta[i], amp_n[i])
            noise = lambda: rng.normal(0.02, 0.01, (size, size)).astype(np.float32)  # noqa: E731
            ring = np.clip(cells - nuclei, 0, None)
            stack = np.stack([nuclei + noise(), ring + noise(),
                              0.5 * nuclei + 0.5 * cells + noise(), cells + noise(),
                              ring * 0.8 + noise()])
            out[p, t, :, 0] = np.clip(np.rint(stack * 4096), 0, 65535).astype(np.uint16)
    return out
