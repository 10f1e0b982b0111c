"""Puncta (spot) detection, the in-process spotiflow equivalent
(counterpart of ``aliby_tpu/models/spots.py``).

Scale-normalised Laplacian-of-Gaussian maxima over a small sigma sweep (the
classic blob detector), each detection painted as a disk labelled 1..n.
Every function takes a batch of frames ``(B, Y, X)`` on one device; the
segmenter closure has the spotiflow shape contract (a list of 2-D uint16
masks).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from aliby_tpu_torch.device import resolve_device
from aliby_tpu_torch.ops.imageops import gaussian_blur, peak_local_max

SIGMAS = (1.5, 2.5, 3.5)


def _edge_shift(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """``out[y, x] = a[clip(y + dy), clip(x + dx)]`` per image of (B, H, W)
    (edge replication: a roll would wrap and make border blobs)."""
    B, H, W = a.shape
    ys = torch.arange(H, device=a.device).add_(dy).clamp_(0, H - 1)
    xs = torch.arange(W, device=a.device).add_(dx).clamp_(0, W - 1)
    return a.index_select(1, ys).index_select(2, xs)


def detect_spots(img: torch.Tensor, sigmas: tuple[float, ...] = SIGMAS,
                 threshold_rel: float = 0.2, min_distance: int = 3, max_spots: int = 512):
    """(B, Y, X) frames -> (coords (B, max_spots, 2) int32, radii (B,
    max_spots) f32, valid (B, max_spots) bool), each frame as the
    reference's ``detect_spots``: z-scored (population std, ddof 0), the LoG
    response at each sigma, its maximum over scales (the first scale on
    ties) outside a blur-support margin, peaks above ``threshold_rel`` of
    the frame's best response, radius sigma * sqrt(2) of the peak's scale."""
    img = img.to(torch.float32)
    B, H, W = img.shape
    # the mean and the population std accumulate in float64, rounded once:
    # the card's and the CPU's reduction orders then give the same f32 bits
    mean = img.double().mean(dim=(1, 2), keepdim=True).to(torch.float32)
    centred = img - mean
    std = (centred.double() ** 2).mean(dim=(1, 2), keepdim=True).sqrt().to(torch.float32)
    img = centred / torch.clamp_min(std, 1e-6)
    best = best_scale = None
    for i, s in enumerate(sigmas):
        g = gaussian_blur(img, s)
        lap = (-4 * g + _edge_shift(g, 1, 0) + _edge_shift(g, -1, 0)
               + _edge_shift(g, 0, 1) + _edge_shift(g, 0, -1))
        resp = -lap * np.float32(s ** 2)
        if best is None:
            best, best_scale = resp, torch.zeros(resp.shape, dtype=torch.int64, device=img.device)
        else:
            better = resp > best  # argmax keeps the first index on ties
            best_scale = torch.where(better, i, best_scale)
            best = torch.maximum(best, resp)
    margin = int(max(sigmas)) + 1
    interior = torch.zeros((H, W), dtype=torch.bool, device=img.device)
    interior[margin:H - margin, margin:W - margin] = True
    best = torch.where(interior, best, torch.full((), -math.inf, device=img.device))
    thr = np.float32(threshold_rel) * best.reshape(B, -1).amax(dim=1)
    coords, valid = peak_local_max(best, min_distance=min_distance, threshold=thr,
                                   max_peaks=max_spots)
    flat = coords[..., 0].to(torch.int64) * W + coords[..., 1]
    scale = torch.gather(best_scale.reshape(B, -1), 1, flat)
    table = torch.tensor(sigmas, dtype=torch.float32, device=img.device)
    radii = table[scale] * np.float32(math.sqrt(2.0))
    return coords, radii, valid


def paint_spots(shape: tuple[int, int], coords: torch.Tensor, radii: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """Labelled disk masks (B, Y, X) int32 from detections: spot i -> label
    i + 1 on the pixels with ``dy^2 + dx^2 <= r^2``, and where disks overlap
    the lowest i wins (the reference's loop, first writer wins, in one
    scatter-min over the disks' bounding boxes)."""
    H, W = shape
    B, S = valid.shape
    dev = coords.device
    R = int(math.ceil(float(radii.max()))) if S and bool(valid.any()) else 0
    off = torch.arange(-R, R + 1, device=dev)
    dy, dx = torch.meshgrid(off, off, indexing="ij")
    dy, dx = dy.reshape(1, 1, -1), dx.reshape(1, 1, -1)  # (1, 1, P)
    y = coords[..., 0:1].to(torch.int64) + dy  # (B, S, P)
    x = coords[..., 1:2].to(torch.int64) + dx
    d2 = (dy * dy + dx * dx).to(torch.float32)  # exact: small integers
    r2 = (radii * radii).unsqueeze(-1)
    inside = (d2 <= r2) & valid.unsqueeze(-1) & (y >= 0) & (y < H) & (x >= 0) & (x < W)
    spot = torch.arange(S, device=dev).reshape(1, S, 1).expand_as(y)
    flat = (torch.arange(B, device=dev).reshape(B, 1, 1) * (H * W) + y * W + x)[inside]
    first = torch.full((B * H * W,), S, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, flat, spot[inside], reduce="amin")
    labels = torch.where(first < S, first + 1, 0)
    return labels.to(torch.int32).reshape(B, H, W)


def make_spot_segmenter(channel_to_segment: int = 0, device=None, **kwargs):
    """Closure with the spotiflow shape contract: (F, C, Z, Y, X) pixels (a
    leading T of 1 dropped, Z max-projected) -> list of 2-D uint16 masks.
    The frames of a call are detected and painted as one batch."""
    det_kwargs = {k: kwargs[k] for k in ("sigmas", "threshold_rel", "min_distance", "max_spots")
                  if k in kwargs}
    if "sigmas" in det_kwargs:
        det_kwargs["sigmas"] = tuple(det_kwargs["sigmas"])
    device = resolve_device(device)

    def segment(pixels, **_ignored):
        pixels = np.asarray(pixels, np.float32)
        if pixels.ndim == 6:
            pixels = pixels[0]
        sel = pixels[:, channel_to_segment]
        sel = sel.max(axis=1) if sel.shape[1] > 1 else sel[:, 0]
        frames = torch.from_numpy(np.ascontiguousarray(sel)).to(device)
        with torch.no_grad():
            coords, radii, valid = detect_spots(frames, **det_kwargs)
            labels = paint_spots(tuple(sel.shape[1:]), coords, radii, valid).cpu().numpy()
        return [m.astype(np.uint16) for m in labels]

    segment.device = device
    return segment
