"""Label batches for the hole-filling tests (``ops/labels.fill_label_holes``):
each case a (B, 64, 64) int32 batch, shared by the CPU tests against the JAX
package and the card's tests against the plain version; and
:func:`pattern_label_maps`, the benchmark's fields as label maps."""

import json
from pathlib import Path

import numpy as np

CONFIG = Path(__file__).resolve().parents[1] / "gpubench" / "configs" / "cellposenet-jump1080.json"


def ring(H, W, cy, cx, r_out, r_in, label):
    yy, xx = np.mgrid[0:H, 0:W]
    r2 = (yy - cy) ** 2 + (xx - cx) ** 2
    return np.where((r2 <= r_out**2) & (r2 >= r_in**2), label, 0).astype(np.int32)


def _annulus_and_u():
    ann = ring(64, 64, 32, 32, 20, 8, 1)
    ann[2:10, 2:10] = 2  # a second object touching nothing
    ann[50:60, 3:5] = 3
    cshape = np.zeros((64, 64), np.int32)  # a U open to the border stays open
    cshape[40:60, 40:60] = 4
    cshape[45:60, 45:55] = 0
    return np.stack([ann, np.maximum(ann, cshape)])


def _snake():
    lab = np.zeros((64, 64), np.int32)
    lab[8:56, 8:56] = 5
    for i, y in enumerate(range(12, 52, 4)):  # a serpentine hole, one path
        lab[y, 12:52] = 0
        if y + 4 < 52:
            x = 51 if i % 2 == 0 else 12
            lab[y : y + 5, x] = 0
    return lab[None]


def _nested():
    outer = ring(64, 64, 32, 32, 28, 20, 1)  # the gap between the rings borders 1 and 2
    inner = ring(64, 64, 32, 32, 14, 5, 2)  # its hole borders 2 alone
    return np.maximum(outer, inner)[None]


def _two_labels():
    lab = np.zeros((64, 64), np.int32)
    lab[10:50, 10:32] = 1
    lab[10:50, 32:50] = 2
    lab[25:35, 25:40] = 0  # a hole on both labels stays 0
    lab[40:45, 14:18] = 0  # one inside label 1 alone is filled
    return lab[None]


def _channel():
    lab = np.zeros((64, 64), np.int32)
    lab[6:58, 6:58] = 6
    lab[20:40, 20:40] = 0  # a pocket...
    lab[30, 40:50] = 0  # ...reaching the border through a bent one-pixel channel
    lab[30:58, 49] = 0
    return lab[None]


def _on_the_edge():
    lab = ring(64, 64, 10, 32, 10, 4, 7)  # touches the top row; its hole is enclosed
    lab = np.maximum(lab, ring(64, 64, 0, 8, 8, 3, 8))  # cut by the border: hole open
    lab[40:64, 40:64] = 9  # in the corner, with a hole
    lab[50:55, 50:55] = 0
    return lab[None]


def _label_256():
    return ring(64, 64, 30, 34, 18, 9, 256)[None]


def _batch():
    rng = np.random.default_rng(3)
    blobs = (rng.random((64, 64)) < 0.55).astype(np.int32) * rng.integers(1, 4, (64, 64))
    return np.stack([_annulus_and_u()[1], blobs.astype(np.int32), np.zeros((64, 64), np.int32),
                     _nested()[0]])


FILL_CASES = {
    "annulus_and_u": _annulus_and_u,
    "snake": _snake,
    "nested_annuli": _nested,
    "hole_on_two_labels": _two_labels,
    "channel_to_the_border": _channel,
    "objects_on_the_edge": _on_the_edge,
    "empty": lambda: np.zeros((1, 64, 64), np.int32),
    "all_foreground": lambda: np.arange(1, 64 * 64 + 1, dtype=np.int32).reshape(1, 64, 64) % 7 + 1,
    "label_256": _label_256,
    "batch_of_differing_images": _batch,
}


def pattern_label_maps(n_fields: int = 9, size: int | None = None,
                       cells: int | None = None) -> np.ndarray:
    """(2 n_fields, size, size) int32 label maps, nuclei then cells of each
    field, drawn from the ``field`` block of the benchmark's configuration
    (its size, cell count, semi-axes, spacing, edge margin and nucleus
    fraction; ``size`` and ``cells`` may be cut), each ellipse on its
    bounding box, and a 3 x 3 hole at the centre of every third object: the
    batch of one segmentation call of the benchmark, with holes to fill."""
    field = json.loads(CONFIG.read_text())["field"]
    size = size or field["size"]
    cells = cells or field["cells"]
    (a_lo, a_hi), (b_lo, b_hi) = field["cell_semi_axes_px"]
    margin, gap = field["edge_margin_px"], field["min_centre_distance_px"]
    r = int(np.ceil(max(a_hi, b_hi))) + 2
    rng = np.random.default_rng(5)
    maps = []
    for _ in range(n_fields):
        cell = np.zeros((size, size), np.int32)
        nuc = np.zeros((size, size), np.int32)
        centers = []
        while len(centers) < cells:
            c = rng.uniform(margin, size - margin, 2)
            if centers and np.min(np.hypot(*(np.array(centers) - c).T)) < gap:
                continue
            centers.append(c)
            a, b, theta = rng.uniform(a_lo, a_hi), rng.uniform(b_lo, b_hi), rng.uniform(0, np.pi)
            y0, x0 = max(int(c[0]) - r, 0), max(int(c[1]) - r, 0)
            yy, xx = np.mgrid[y0 : min(int(c[0]) + r + 1, size), x0 : min(int(c[1]) + r + 1, size)]
            u = (xx - c[1]) * np.cos(theta) + (yy - c[0]) * np.sin(theta)
            v = -(xx - c[1]) * np.sin(theta) + (yy - c[0]) * np.cos(theta)
            n = len(centers)
            for lab, f in ((cell, 1.0), (nuc, field["nucleus_frac"])):
                box = lab[y0 : y0 + yy.shape[0], x0 : x0 + yy.shape[1]]
                box[((u / (a * f)) ** 2 + (v / (b * f)) ** 2 <= 1.0) & (box == 0)] = n
                if n % 3 == 0:
                    cy, cx = int(c[0]), int(c[1])
                    lab[cy - 1 : cy + 2, cx - 1 : cx + 2] = 0
        maps += [nuc, cell]
    return np.stack(maps)
