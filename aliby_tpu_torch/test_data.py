"""Synthetic fields, numpy only, so the port and ``chip_smoke.py`` can make
inputs without JAX: copies of ``aliby_tpu/test_data.render_cells``, of the
bench's five-channel Cell Painting field builder, of the yeast time-lapse
(``yeast_timelapse``, the ``yeast_zarr`` fixture's generator) and the
budding-yeast movie, and a bright-field ALCATRAS-like trap field
(``render_trap_field``, the renderer of ``tests/test_trap_hardening.py``).

:func:`get_dataset_path` makes (once) the JAX package's Cell Painting
fixtures with the same pixels: ``cellpainting_zarr`` (a zarr store of two
CYX positions, written with the port's ``io.zarrlite``) and
``crop_cellpainting_256`` (a TIFF directory, PIL imported where it is
written), under the port's own cache directory
(``$ALIBY_TPU_TORCH_FIXTURES``, else ``~/.cache/aliby_tpu_torch/fixtures``).
"""

from __future__ import annotations

import os
from pathlib import Path

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


def _to_uint16(img: np.ndarray, rng: np.random.Generator, peak: float = 12000.0) -> np.ndarray:
    noisy = img * peak + rng.normal(200.0, 30.0, img.shape)
    return np.clip(noisy, 0, 65535).astype(np.uint16)


def yeast_timelapse(seed: int, T: int = 4, C: int = 3, Z: int = 3, size: int = 293) -> np.ndarray:
    """A drifting yeast-like time-lapse, (T, C, Z, Y, X) uint16: the
    ``yeast_zarr`` fixture's positions are ``yeast_timelapse(40 + field)``
    at 293 x 293 (the JAX package's ``test_data._yeast_timelapse``)."""
    rng = np.random.default_rng(seed)
    cells, nuclei, _ = render_cells(size, 18, rng)
    out = np.zeros((T, C, Z, size, size), np.uint16)
    for t in range(T):
        dy, dx = int(round(1.5 * t)), int(round(-1.0 * t))
        shifted = np.roll(np.roll(cells, dy, 0), dx, 1)
        nshift = np.roll(np.roll(nuclei, dy, 0), dx, 1)
        growth = 1.0 + 0.05 * t
        for z in range(Z):
            zfac = 1.0 - 0.25 * abs(z - Z // 2)
            out[t, 0, z] = _to_uint16(shifted * zfac * growth, rng, peak=9000)
            if C > 1:
                out[t, 1, z] = _to_uint16(nshift * zfac, rng, peak=11000)
            if C > 2:
                out[t, 2, z] = _to_uint16((shifted - nshift).clip(0) * zfac, rng, peak=7000)
    return out


def render_budding_movie(size: int, T: int, rng: np.random.Generator, n_mothers: int = 5,
                         bud_max_radius: float = 6.0):
    """Synthetic budding-yeast movie with ground-truth lineage: ``(frames
    (T, Y, X) f32, labels (T, Y, X) int32 persistent ids, lineage
    {bud_label: mother_label})``. Mothers are fixed rotated ellipses; each
    sprouts one bud at a random tp >= 1 on its rim, touching it at the neck
    and growing (the JAX package's ``test_data.render_budding_movie``)."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    margin = 28
    mothers: list[dict] = []
    label = 0
    attempts = 0
    while len(mothers) < n_mothers and attempts < n_mothers * 50:
        attempts += 1
        cy, cx = rng.uniform(margin, size - margin, 2)
        if mothers and min(np.hypot(m["cy"] - cy, m["cx"] - cx) for m in mothers) < 46:
            continue
        label += 1
        mothers.append(dict(cy=cy, cx=cx, a=rng.uniform(10, 14), b=rng.uniform(8, 12),
                            theta=rng.uniform(0, np.pi), label=label))
    lineage: dict[int, int] = {}
    buds = []
    for m in mothers:
        label += 1
        buds.append(dict(mother=m, tp0=int(rng.integers(1, max(2, T - 1))),
                         psi=rng.uniform(0, 2 * np.pi), label=label))
        lineage[label] = m["label"]

    def _paint(frame, labels_map, cy, cx, a, b, theta, lbl, overwrite=False):
        ct, st = np.cos(theta), np.sin(theta)
        u = (xx - cx) * ct + (yy - cy) * st
        v = -(xx - cx) * st + (yy - cy) * ct
        d2 = (u / a) ** 2 + (v / b) ** 2
        inside = d2 <= 1.0
        np.maximum(frame, np.clip(1.2 - d2, 0, None), out=frame)
        if overwrite:
            labels_map[inside] = lbl
        else:
            labels_map[inside & (labels_map == 0)] = lbl

    frames = np.zeros((T, size, size), np.float32)
    labels = np.zeros((T, size, size), np.int32)
    for t in range(T):
        for m in mothers:
            _paint(frames[t], labels[t], m["cy"], m["cx"], m["a"], m["b"], m["theta"], m["label"])
        for bud in buds:
            if t < bud["tp0"]:
                continue
            m = bud["mother"]
            r = min(1.0, 0.35 + 0.35 * (t - bud["tp0"])) * bud_max_radius
            ct, st = np.cos(m["theta"]), np.sin(m["theta"])
            px = m["a"] * np.cos(bud["psi"])
            py = m["b"] * np.sin(bud["psi"])
            bx = m["cx"] + px * ct - py * st
            by = m["cy"] + px * st + py * ct
            out_dir = np.array([by - m["cy"], bx - m["cx"]])
            out_dir = out_dir / max(np.hypot(*out_dir), 1e-6)
            # buds overwrite the mother at the neck: they are the newer cell
            _paint(frames[t], labels[t], by + out_dir[0] * r * 0.8, bx + out_dir[1] * r * 0.8,
                   r, r, 0.0, bud["label"], overwrite=True)
        frames[t] += rng.normal(0.0, 0.02, (size, size)).astype(np.float32)
    return frames, labels, lineage


def _blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """Separable Gaussian with reflect padding, truncated at 4 sigma
    (``scipy.ndimage.gaussian_filter``'s defaults, in numpy)."""
    r = int(4.0 * sigma + 0.5)
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    out = img.astype(np.float64)
    for axis in (0, 1):
        pad = [(0, 0), (0, 0)]
        pad[axis] = (r, r)
        p = np.pad(out, pad, mode="symmetric")
        n = out.shape[axis]
        out = sum(k[j] * np.take(p, np.arange(j, j + n), axis=axis) for j in range(2 * r + 1))
    return out


def render_trap_field(size: int = 420, spacing: int = 60, trap: int = 18, seed: int = 0,
                      illumination: float = 0.0, defocus: float = 0.0, n_debris: int = 0,
                      occupancy: float = 0.0, edge_offset: int = 20,
                      drift: tuple[float, float] = (0.0, 0.0)):
    """Bright-field-like ALCATRAS trap grid: U-shaped trap walls (three bars
    brighter than the background) on a noisy field, with optional
    degradations (illumination ramp, defocus blur, debris, cells in traps,
    drift). Returns ``(image (size, size) f32, interior_truth_centres
    (N, 2))``; traps within ``trap`` px of the border are rendered but not
    in the truth. The renderer of ``tests/test_trap_hardening.py``, with
    its defocus blur in numpy."""
    rng = np.random.default_rng(seed)
    img = rng.normal(100.0, 3.0, (size, size)).astype(np.float32)
    n = (size - 2 * edge_offset) // spacing
    centres = []
    dy, dx = drift
    h = trap // 2

    def xs(a, b):
        return slice(max(0, a), min(size, b))

    for i in range(n + 1):  # +1 row/col so some traps straddle the edge
        for j in range(n + 1):
            cy = edge_offset + spacing // 2 + i * spacing + dy
            cx = edge_offset + spacing // 2 + j * spacing + dx
            iy, ix = int(round(cy)), int(round(cx))
            ys = slice(max(0, iy - h), min(size, iy + h))
            img[ys, xs(ix - h, ix - h + 3)] += 80
            img[ys, xs(ix + h - 3, ix + h)] += 80
            img[slice(max(0, iy + h - 3), min(size, iy + h)), xs(ix - h, ix + h)] += 80
            if rng.uniform() < occupancy:
                yy, xx = np.mgrid[0:size, 0:size]
                cell = (yy - iy) ** 2 + (xx - ix + 2) ** 2 <= (h - 5) ** 2
                img[cell] += rng.uniform(20, 45)
            if trap <= iy <= size - trap and trap <= ix <= size - trap:
                centres.append((cy, cx))
    for _ in range(n_debris):
        yy, xx = np.mgrid[0:size, 0:size]
        by, bx = rng.uniform(0, size, 2)
        r = rng.uniform(3, 9)
        img[(yy - by) ** 2 + (xx - bx) ** 2 <= r ** 2] += rng.choice([-60.0, 120.0])
    if defocus > 0:
        img = _blur(img, defocus)
    if illumination > 0:
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
        img = img * (1.0 + illumination * ((yy / size - 0.5) + 0.6 * (xx / size - 0.5)))
    return img.astype(np.float32), np.asarray(centres, np.float64)


def yeast_trap_movie(T: int = 5, size: int = 1024, spacing: int = 160, trap: int = 52,
                     seed: int = 17, C: int = 3, Z: int = 3):
    """Yeast in ALCATRAS-like traps over time, (T, C, Z, size, size) uint16,
    and the rendered trap centres (N, 2) of frame 0.

    Channel 0 is bright field: the trap grid of :func:`render_trap_field`
    at this spacing and trap size, with the cells faintly visible.
    Channels 1 and 2 are fluorescence: each trap holds one or two mother
    cells (ellipses, 5 to 9 px semi-axes) near its centre, a third of them
    growing a bud from a random timepoint on, cytoplasm in channel 1 and
    the nucleus in channel 2. The stage drifts by whole pixels (about 1 px
    a timepoint); the z planes dim away from the middle one."""
    rng = np.random.default_rng(seed)
    bf, centres = render_trap_field(size=size, spacing=spacing, trap=trap, seed=seed)
    cells = []
    for cy, cx in np.asarray(centres):
        for k in range(int(rng.integers(1, 3))):
            a, b = rng.uniform(6, 9), rng.uniform(5, 7)
            oy, ox = rng.uniform(-6, 6), rng.uniform(-6, 6) + (0 if k == 0 else 14)
            bud = None
            if rng.random() < 1 / 3:
                bud = (int(rng.integers(1, max(2, T))), rng.uniform(0, 2 * np.pi))
            cells.append((cy - trap * 0.1 + oy, cx + ox, a, b, rng.uniform(0, np.pi),
                          rng.uniform(0.7, 1.0), bud))
    out = np.zeros((T, C, Z, size, size), np.uint16)
    for t in range(T):
        cyto = np.zeros((size, size), np.float32)
        nuc = np.zeros((size, size), np.float32)
        for cy, cx, a, b, theta, amp, bud in cells:
            _render_ellipse(cyto, cy, cx, a, b, theta, amp)
            _render_ellipse(nuc, cy, cx, a * 0.45, b * 0.45, theta, amp)
            if bud is not None and t >= bud[0]:
                r = min(1.0, 0.4 + 0.3 * (t - bud[0])) * 5.0
                by = cy + (b + r * 0.8) * np.sin(bud[1])
                bx = cx + (a + r * 0.8) * np.cos(bud[1])
                _render_ellipse(cyto, by, bx, r, r, 0.0, amp)
        dy, dx = int(round(0.8 * t)), int(round(-0.6 * t))
        frames = [bf + 25.0 * cyto, cyto, nuc]
        for c in range(C):
            frame = np.roll(frames[c % 3], (dy, dx), axis=(0, 1))
            for z in range(Z):
                zfac = 1.0 - 0.25 * abs(z - Z // 2)
                if c == 0:
                    img = frame * (0.9 + 0.1 * zfac) + rng.normal(0, 2.0, frame.shape)
                else:
                    img = frame * zfac * (9000 if c == 1 else 6000) + rng.normal(200, 30,
                                                                                 frame.shape)
                out[t, c, z] = np.clip(img, 0, 65535).astype(np.uint16)
    return out, np.asarray(centres)


# ---------------------------------------------------------------------------
# the Cell Painting fixtures (``aliby_tpu/test_data.py``'s catalogue)
# ---------------------------------------------------------------------------

CP_CHANNELS = {"DNA": 0, "ER": 1, "RNA": 2, "AGP": 3, "Mito": 4}

DATASETS = {
    "crop_cellpainting_256": {
        "name": "crop_cellpainting_256",
        "regex": r".*__([A-Z][0-9]{2})__([0-9])__([A-Za-z]+)\.tif",
        "capture_order": "WFC",
        "channels": dict(CP_CHANNELS),
        "kind": "tiff_dir",
    },
    "cellpainting_zarr": {
        "name": "cellpainting_zarr",
        "capture_order": "CYX",
        "channels": dict(CP_CHANNELS),
        "kind": "zarr",
    },
}


def fixtures_root() -> Path:
    root = os.environ.get("ALIBY_TPU_TORCH_FIXTURES")
    if root:
        return Path(root)
    return Path.home() / ".cache" / "aliby_tpu_torch" / "fixtures"


def _channel_stack(size: int, n_cells: int, seed: int, n_channels: int = 5):
    """Stack of channels derived from one rendered field (uint16)."""
    rng = np.random.default_rng(seed)
    cells, nuclei, labels = render_cells(size, n_cells, rng)
    ring = np.clip(cells - nuclei, 0, None)
    per_channel = [nuclei, ring, 0.5 * nuclei + 0.5 * cells, cells, ring * 0.8 + 0.2 * cells]
    out = np.stack([_to_uint16(per_channel[c % 5], rng) for c in range(n_channels)])
    return out, labels


def _build_crop_cellpainting_256(root: Path) -> None:
    from PIL import Image

    for wi, well in enumerate(["A01"]):
        for field in [1]:
            stack, _ = _channel_stack(256, 24, seed=100 + wi * 10 + field)
            for ch_name, ch_idx in CP_CHANNELS.items():
                Image.fromarray(stack[ch_idx]).save(
                    str(root / f"plate1__{well}__{field}__{ch_name}.tif"))


def _build_cellpainting_zarr(root: Path) -> None:
    from aliby_tpu_torch.io import zarrlite

    for wi, well in enumerate(["A01", "B02"]):
        stack, _ = _channel_stack(256, 24, seed=100 + wi * 10 + 1)
        zarrlite.write_array(root / well, stack, chunks=(1, 256, 256))


_BUILDERS = {
    "crop_cellpainting_256": _build_crop_cellpainting_256,
    "cellpainting_zarr": _build_cellpainting_zarr,
}


def get_dataset(name: str) -> dict:
    if name not in DATASETS:
        raise KeyError(f"Unknown dataset {name!r}; known: {sorted(DATASETS)}")
    return dict(DATASETS[name])


def get_dataset_path(name: str) -> Path:
    """Generate (once) and return the root path of a synthetic dataset."""
    entry = get_dataset(name)
    root = fixtures_root() / entry["name"]
    marker = root / ".complete"
    if not marker.exists():
        root.mkdir(parents=True, exist_ok=True)
        _BUILDERS[name](root)
        marker.write_text("ok")
    return root


# ---------------------------------------------------------------------------
# seeded Cellpose checkpoints
# ---------------------------------------------------------------------------

# the head of a seeded CPnet: its 1x1 conv scaled by HEAD_GAIN, then its
# bias shifted so that, on a probe Cell Painting field, the flows average 0
# and the cell logit averages HEAD_LIFT: the output varies across a field
# and mask reconstruction finds objects (~200 a 256^2 field at the cyto
# width without the flow-error QC, a few with it: random flows fail the QC)
HEAD_GAIN = 20.0
HEAD_LIFT = 1.75


def cpnet_state_dict(seed: int = 0, nbase=(2, 32, 64, 128, 256), nout: int = 3,
                     sz: int = 3) -> dict:
    """A torch Cellpose ``state_dict`` in the published key layout, made
    from ``seed`` with numpy: convolutions and Dense layers uniform in
    +-1/sqrt(fan_in) (PyTorch's default initialisation), BatchNorm running
    means N(0, 0.3) and variances U(0.5, 1.5) (scale 1, shift 0), and the
    head scaled by ``HEAD_GAIN`` and centred on a probe field (``HEAD_LIFT``).
    Tensors on the CPU."""
    import torch

    from aliby_tpu_torch.models.cpnet import CPnet

    rng = np.random.default_rng(seed)
    keys = CPnet(nbase=nbase, nout=nout, sz=sz).state_dict()
    sd = {}
    for k, t in keys.items():
        shape = tuple(t.shape)
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.zeros((), dtype=torch.int64)
            continue
        if k.endswith("running_mean"):
            v = rng.normal(0.0, 0.3, shape)
        elif k.endswith("running_var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif len(shape) >= 2 or k.endswith("bias") and k[:-4] + "weight" in keys \
                and keys[k[:-4] + "weight"].dim() >= 2:
            w = keys[k[:-4] + "weight"] if k.endswith("bias") else t
            bound = 1.0 / np.sqrt(int(np.prod(w.shape[1:])))
            v = rng.uniform(-bound, bound, shape)
        else:  # BatchNorm scale and shift
            v = np.ones(shape) if k.endswith("weight") else np.zeros(shape)
        sd[k] = torch.from_numpy(np.asarray(v, np.float32))
    sd["output.2.weight"] *= HEAD_GAIN
    sd["output.2.bias"] *= HEAD_GAIN
    model = CPnet(nbase=nbase, nout=nout, sz=sz)
    model.load_state_dict(sd)
    probe = cellpainting_fields(1, 64, seed=7)[0][:, [3, 0], 0].astype(np.float32)
    x = torch.from_numpy(probe).permute(0, 2, 3, 1)
    lo = torch.quantile(x.reshape(-1, 2), 0.01, dim=0)
    hi = torch.quantile(x.reshape(-1, 2), 0.99, dim=0)
    with torch.no_grad():
        out, _ = model(((x - lo) / (hi - lo)).float())
    shift = -out.reshape(-1, nout).mean(dim=0)
    shift[min(2, nout - 1)] += HEAD_LIFT
    sd["output.2.bias"] = sd["output.2.bias"] + shift
    return sd
