"""Yeast-trap (ALCATRAS) detection (counterpart of ``aliby_tpu/tile/traps.py``).

Behavioural model (``tile/process_traps.py:24-218`` of the reference):
entropy-texture segmentation finds candidate traps, their mean crop becomes
a matched template, and normalised cross-correlation (4 rotations x 10
scales) with minimum-distance peak picking gives the trap grid. A result
with fewer than ``min_traps`` traps triggers a retry at full resolution,
keeping whichever run found more.

The image filters, connected components and label statistics run on
``device`` (``cuda`` unless the caller passes ``device="cpu"``); only the
candidate bookkeeping, the template crops and the per-map quantile are
host numpy, once per position.
"""

from __future__ import annotations

import numpy as np
import torch

from aliby_tpu_torch.device import resolve_device
from aliby_tpu_torch.extract.reductions import LabelStats, ellipse_params
from aliby_tpu_torch.ops import imageops as I
from aliby_tpu_torch.ops.labels import connected_components, relabel_sequential_batched


class TrapDetectionError(RuntimeError):
    """No trap found (the tiler then falls back to one centred tile)."""


def _candidate_centres(img: torch.Tensor, tile_size: int, downscale: float) -> np.ndarray:
    """Entropy -> Otsu -> closing -> clear_border -> CC -> shape filter, on
    a (1, H, W) image; returns the kept label centroids (N, 2)."""
    _, H, W = img.shape
    small = I.resize_bilinear(img, (int(H * downscale), int(W * downscale))) \
        if downscale != 1.0 else img
    radius = max(2, int(round(tile_size * downscale / 10)))
    ent = I.entropy_filter(small, radius=radius)
    ent_full = I.resize_bilinear(ent, (H, W))
    thr = I.otsu_threshold(ent_full)
    binary = I.binary_closing(ent_full > thr.reshape(-1, 1, 1), 2)
    labels = I.clear_border(connected_components(binary, connectivity=2))
    max_labels = 256
    labels, _ = relabel_sequential_batched(labels, max_labels)
    st = LabelStats(labels, max_labels)
    mu20, mu02, mu11 = st.central_moments()
    major = ellipse_params(mu20, mu02, mu11, st.area)[0]
    area, major, cy, cx = (t[0].cpu().numpy() for t in (st.area, major, st.cy, st.cx))
    half = tile_size // 2
    keep = ((area > 0) & (major > 0.3 * tile_size) & (major < tile_size)
            & (cy > half) & (cy < H - half) & (cx > half) & (cx < W - half))
    return np.stack([cy[keep], cx[keep]], axis=1)


def _mean_template(image: np.ndarray, centres: np.ndarray, size: int) -> np.ndarray:
    half = size // 2
    crops = []
    for cy, cx in centres:
        y0, x0 = int(round(cy)) - half, int(round(cx)) - half
        crop = image[y0: y0 + size, x0: x0 + size]
        if crop.shape == (size, size):
            crops.append(crop)
    if not crops:
        raise TrapDetectionError("No valid template crops")
    return np.mean(crops, axis=0).astype(np.float32)


def identify_trap_locations(image, template: np.ndarray, trap_size: int,
                            min_score: float = 0.3, max_peaks: int = 512,
                            device=None) -> np.ndarray:
    """Template matching over 4 rotations x 10 scales -> trap centres (N, 2)
    int32, the best scale's peaks in the order ``peak_local_max`` ranks them."""
    img = image if isinstance(image, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(image, np.float32)).to(resolve_device(device))
    img = img.reshape((1,) + tuple(img.shape[-2:])).to(torch.float32)
    dev = img.device
    best_rot, best_q = None, -np.inf
    for k in range(4):  # the best rotation by the 99.9th-percentile NCC score
        tpl = np.rot90(template, k)
        ncc = I.match_template(img, torch.from_numpy(np.ascontiguousarray(tpl)).to(dev))
        q = float(np.quantile(ncc[0].cpu().numpy(), 0.999))
        if q > best_q:
            best_q, best_rot = q, tpl
    best = None
    rot = torch.from_numpy(np.ascontiguousarray(best_rot, np.float32)).to(dev)[None]
    for scale in np.linspace(0.5, 2.0, 10):
        size = max(8, int(round(best_rot.shape[0] * scale)))
        tpl = I.resize_bilinear(rot, (size, size))[0]
        ncc = I.match_template(img, tpl)
        coords, valid = I.peak_local_max(ncc, min_distance=max(1, int(0.7 * trap_size)),
                                         threshold=min_score, max_peaks=max_peaks)
        coords = coords[0][valid[0]].cpu().numpy()
        scores = ncc[0].cpu().numpy()[tuple(coords.T)] if len(coords) else np.zeros(0)
        quality = scores.mean() * np.sqrt(len(coords)) if len(coords) else -np.inf
        if best is None or quality > best[0]:
            best = (quality, coords)
    return best[1]


def segment_traps(image: np.ndarray, tile_size: int, downscale: float = 0.4,
                  min_traps: int = 30, device=None) -> np.ndarray:
    """Full trap detection with the reference's retry-at-full-resolution
    policy; raises :class:`TrapDetectionError` when no trap is found."""
    image = np.asarray(image, np.float32)
    img = torch.from_numpy(np.ascontiguousarray(image)).to(resolve_device(device))[None]

    def run(ds: float) -> np.ndarray:
        centres = _candidate_centres(img, tile_size, ds)
        if len(centres) == 0:
            raise TrapDetectionError("no candidate traps")
        template = _mean_template(image, centres, tile_size // 2)
        return identify_trap_locations(img, template, tile_size)

    with torch.no_grad():
        try:
            traps = run(downscale)
        except TrapDetectionError:
            traps = np.zeros((0, 2))
        if len(traps) < min_traps and downscale != 1.0:
            try:
                retry = run(1.0)
                if len(retry) > len(traps):
                    traps = retry
            except TrapDetectionError:
                pass
    if len(traps) == 0:
        raise TrapDetectionError("no traps found")
    return traps
