"""The benchmark's plate: Cell Painting fields rendered from the seed and
written as uncompressed 16-bit TIFFs in JUMP's file naming.

A field is five channels (DNA, ER, RNA, AGP, Mito) of ``size``^2 uint16
holding elliptical cells whose nuclei are copies of them scaled down,
placed and shaped by the field's own generator, with fresh Gaussian noise a
channel. The objects' number, sizes and spacing are the configuration's
``field`` block (``cells``, ``cell_semi_axes_px``, ``nucleus_frac``,
``min_centre_distance_px``, ``edge_margin_px``). Fields are rendered in
parallel worker processes; field ``i`` of a plate seed is the same whatever
the number of workers, and a run's seed orders the fields over the plate.

Files follow the Phenix (Opera/Harmony) names of the JUMP consortium's
cpg0016 images, ``r{row}c{col}f{field}p01-ch{channel}sk1fk1fl1.tiff``, with
JUMP's channel numbers: ch1 Mito, ch2 AGP, ch3 RNA, ch4 ER, ch5 DNA.
"""

from __future__ import annotations

import os
import struct
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np

STAINS = ("DNA", "ER", "RNA", "AGP", "Mito")  # the rendered stack's order
REGEX = r".*/(r[0-9]{2}c[0-9]{2})f([0-9]{2})p01-ch([0-9])sk1fk1fl1\.tiff"
CAPTURE_ORDER = "WFC"  # well, field, channel
ROWS_PER_STRIP = 64


def _ellipse(img: np.ndarray, cy, cx, a, b, theta, amp) -> None:
    """img = max(img, amp * clip(1.2 - d2, 0)) for the ellipse (a, b, theta)
    at (cy, cx), on its bounding box only."""
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
    prof = np.clip(1.2 - (u / a) ** 2 - (v / b) ** 2, 0, None).astype(np.float32) * amp
    np.maximum(img[y0:y1, x0:x1], prof, out=img[y0:y1, x0:x1])


def render_field(seed: int, index: int, size: int, field: dict) -> np.ndarray:
    """Field ``index`` of plate ``seed``: (5, size, size) uint16 in
    ``STAINS`` order, intensities rint(4096 x [0, ~1.3]). ``field``: the
    configuration's objects (see the module's docstring)."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), int(index)]))
    n_cells, nucleus_frac = field["cells"], field["nucleus_frac"]
    (a_lo, a_hi), (b_lo, b_hi) = field["cell_semi_axes_px"]
    margin = min(field["edge_margin_px"], max(4, size // 4))
    centers = np.zeros((0, 2))
    attempts = 0
    while len(centers) < n_cells and attempts < n_cells * 30:
        attempts += 1
        c = rng.uniform(margin, size - margin, 2)
        if len(centers) and np.min(np.hypot(*(centers - c).T)) < field["min_centre_distance_px"]:
            continue
        centers = np.vstack([centers, c])
    n = len(centers)
    a, b = rng.uniform(a_lo, a_hi, n), rng.uniform(b_lo, b_hi, n)
    theta = rng.uniform(0, np.pi, n)
    amp_c, amp_n = rng.uniform(0.6, 1.0, n), rng.uniform(0.7, 1.0, n)
    cells = np.zeros((size, size), np.float32)
    nuclei = np.zeros((size, size), np.float32)
    for i in range(n):
        cy, cx = centers[i]
        _ellipse(cells, cy, cx, a[i], b[i], theta[i], amp_c[i])
        _ellipse(nuclei, cy, cx, a[i] * nucleus_frac, b[i] * nucleus_frac, theta[i], amp_n[i])
    ring = np.clip(cells - nuclei, 0, None)
    noise = [rng.normal(0.02, 0.01, (size, size)).astype(np.float32) for _ in range(5)]
    stack = np.stack([nuclei, ring, 0.5 * nuclei + 0.5 * cells, cells, ring * 0.8]) + noise
    return np.clip(np.rint(stack * 4096), 0, 65535).astype(np.uint16)


def write_tiff(path: Path, arr: np.ndarray) -> None:
    """A baseline single-page little-endian TIFF of a 2-D uint16 array,
    uncompressed, strips of ``ROWS_PER_STRIP`` rows."""
    H, W = arr.shape
    data = np.ascontiguousarray(arr, dtype="<u2")
    strips = [data[y:y + ROWS_PER_STRIP].tobytes() for y in range(0, H, ROWS_PER_STRIP)]
    offsets = list(np.cumsum([8] + [len(s) for s in strips[:-1]]))
    ifd_at = 8 + sum(len(s) for s in strips)
    entries = [(256, 4, [W]), (257, 4, [H]), (258, 3, [16]), (259, 3, [1]), (262, 3, [1]),
               (273, 4, offsets), (277, 3, [1]), (278, 4, [ROWS_PER_STRIP]),
               (279, 4, [len(s) for s in strips])]
    extra_at = ifd_at + 2 + 12 * len(entries) + 4
    ifd, extra = struct.pack("<H", len(entries)), b""
    for tag, typ, vals in entries:
        packed = struct.pack("<" + ("H" if typ == 3 else "I") * len(vals), *(int(v) for v in vals))
        if len(packed) <= 4:
            field = packed.ljust(4, b"\0")
        else:
            field = struct.pack("<I", extra_at + len(extra))
            extra += packed
        ifd += struct.pack("<HHI", tag, typ, len(vals)) + field
    ifd += struct.pack("<I", 0)
    with open(path, "wb") as f:
        f.write(b"II" + struct.pack("<HI", 42, ifd_at) + b"".join(strips) + ifd + extra)


def jump_channel(stain: str) -> int:
    """JUMP's Phenix channel number of a stain."""
    return {"Mito": 1, "AGP": 2, "RNA": 3, "ER": 4, "DNA": 5}[stain]


def field_names(wells: int, fields_per_well: int) -> list[tuple[str, str]]:
    """(well, field) names of a plate's first ``wells`` wells in row-major
    order of a 384-well plate (16 rows x 24 columns)."""
    out = []
    for w in range(wells):
        row, col = divmod(w, 24)
        for f in range(fields_per_well):
            out.append((f"r{row + 1:02d}c{col + 1:02d}", f"{f + 1:02d}"))
    return out


def _write_field(root, well: str, field_name: str, stack: np.ndarray) -> None:
    for k, stain in enumerate(STAINS):
        write_tiff(Path(root) / f"{well}f{field_name}p01-ch{jump_channel(stain)}sk1fk1fl1.tiff",
                   stack[k])


def _render_and_write(job) -> np.ndarray:
    root, plate_seed, index, well, field_name, size, field = job
    stack = render_field(plate_seed, index, size, field)
    _write_field(root, well, field_name, stack)
    return stack


def plate_order(seed: int, n: int) -> np.ndarray:
    """The plate's field index at each of its ``n`` positions, from the
    run's seed."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), 0x9A7E])).permutation(n)


def make_plate(root: str | Path, seed: int, wells: int, fields_per_well: int, size: int,
               field: dict, workers: int | None = None) -> dict[str, np.ndarray]:
    """Render and write the plate under ``root``; returns {position key:
    (5, size, size) uint16 stack in ``STAINS`` order}, the key as the
    program's ``DatasetDir`` names a position (``well__field``).

    The plate's fields are fields 0..n-1 of the configuration's
    ``plate_seed``, placed at the plate's positions in an order drawn from
    ``seed``: every seed gives the same work in another order."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    names = field_names(wells, fields_per_well)
    order = plate_order(seed, len(names))
    jobs = [(str(root), field["plate_seed"], int(order[i]), w, f, size, field)
            for i, (w, f) in enumerate(names)]
    workers = workers or min(len(jobs), os.cpu_count() or 1)
    if workers > 1:
        import multiprocessing

        ctx = multiprocessing.get_context("fork")  # the parent has not touched the card yet
        with ProcessPoolExecutor(workers, mp_context=ctx) as pool:
            stacks = list(pool.map(_render_and_write, jobs))
    else:
        stacks = [_render_and_write(j) for j in jobs]
    return {f"{w}__{f}": s for (w, f), s in zip(names, stacks)}


def rewrite_plate(root: str | Path, seed: int, wells: int, fields_per_well: int,
                  by_index: list[np.ndarray]) -> dict[str, np.ndarray]:
    """The plate of ``seed`` written under ``root`` from fields already
    rendered (``by_index[i]``: field ``i`` of the plate seed), as
    :func:`make_plate` would write it."""
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    names = field_names(wells, fields_per_well)
    order = plate_order(seed, len(names))
    for i, (w, f) in enumerate(names):
        _write_field(root, w, f, by_index[order[i]])
    return {f"{w}__{f}": by_index[order[i]] for i, (w, f) in enumerate(names)}


def channel_index(stain: str) -> int:
    """A stain's channel index in a position as the program reads it: the
    files of a position sorted by their JUMP channel number."""
    return jump_channel(stain) - 1


def as_read(stack: np.ndarray) -> np.ndarray:
    """A rendered stack (``STAINS`` order) in the program's channel order."""
    out = np.empty_like(stack)
    for k, stain in enumerate(STAINS):
        out[channel_index(stain)] = stack[k]
    return out
