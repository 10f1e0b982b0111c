"""Segmenter dispatch (counterpart of ``aliby_tpu/models/segment.py``).

``dispatch_segmenter(kind, channel_to_segment, ...)`` returns
``segment(pixels) -> masks`` where ``pixels`` is ``(F, C, Z, Y, X)`` (a
leading T of size 1 is dropped) and ``masks`` is a list of per-tile 2-D
uint16 label maps. This slice ports the ``cellpose`` kind: percentile
normalisation, the U-Net with the bundled weights, and mask
reconstruction, on ``cuda`` unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import warnings
from pathlib import Path

import numpy as np
import torch

from aliby_tpu_torch.device import resolve_device
from aliby_tpu_torch.models.flows import _div, masks_from_flows
from aliby_tpu_torch.models.unet import CellposeNet
from aliby_tpu_torch.models.weights import (
    BUNDLED_WEIGHTS,
    params_from_flax,
    read_flax_checkpoint,
)
from aliby_tpu_torch.ops.imageops import percentile_pair


def _to_uint16(mask: np.ndarray) -> np.ndarray:
    if mask.max() > np.iinfo(np.uint16).max:
        raise ValueError("Label overflow: >65535 objects in one tile.")
    return mask.astype(np.uint16)


def _drop_leading_time(pixels: np.ndarray) -> np.ndarray:
    if pixels.ndim == 6:
        pixels = pixels[0]
    return pixels


def _normalize_percentile(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> each (image, channel) plane mapped by its exact 1st
    and 99th percentiles: (x - lo) / max(hi - lo, 1e-6)."""
    B, H, W, C = x.shape
    rows = x.permute(0, 3, 1, 2).reshape(B * C, H * W)
    lo, hi = percentile_pair(rows, 1.0, 99.0)
    lo = lo.reshape(B, 1, 1, C)
    hi = hi.reshape(B, 1, 1, C)
    return _div(x - lo, torch.clamp_min(hi - lo, 1e-6))


def _pad_to_multiple(img: np.ndarray, m: int = 8):
    H, W = img.shape[-2:]
    ph = (-H) % m
    pw = (-W) % m
    if ph or pw:
        pad = [(0, 0)] * (img.ndim - 2) + [(0, ph), (0, pw)]
        img = np.pad(img, pad, mode="reflect")
    return img, (H, W)


class CellposeTorch:
    """Normalise + U-Net forward + flow reconstruction, with the weights
    of the JAX package's flax checkpoints."""

    def __init__(
        self,
        pretrained_path: str | Path | None = None,
        model_kwargs: dict | None = None,
        cellprob_threshold: float = 0.0,
        flow_iters: int | None = None,
        max_labels: int = 256,
        min_size: int = 15,
        flow_threshold: float | None = 0.4,
        fill_holes: bool = True,
        device: str | torch.device | None = None,
    ):
        model_kwargs = dict(model_kwargs or {})
        arch = model_kwargs.pop("arch", None)
        if pretrained_path is not None and (
            arch == "cpnet"
            or str(pretrained_path).endswith((".pt", ".pth"))
            or "torch" in Path(pretrained_path).name
        ):
            raise NotImplementedError(
                "torch Cellpose checkpoints (models/cpnet.py) are not ported "
                "yet: ROADMAP queue 1, item 10"
            )
        self.device = resolve_device(device)
        self.model = CellposeNet(**model_kwargs)
        path = pretrained_path or (BUNDLED_WEIGHTS if BUNDLED_WEIGHTS.exists() else None)
        if path is not None:
            self.model.load_state_dict(params_from_flax(read_flax_checkpoint(path)))
        else:
            warnings.warn(
                "CellposeTorch running with untrained weights; pass "
                "pretrained_path or bundle weights for real masks."
            )
        self.model.to(self.device).eval()
        # 2 Euler steps, validated for the bundled/flax training pipeline
        self.flow_iters = 2 if flow_iters is None else int(flow_iters)
        self.cellprob_threshold = float(cellprob_threshold)
        self.max_labels = int(max_labels)
        self.min_size = int(min_size)
        self.flow_threshold = None if flow_threshold is None else float(flow_threshold)
        self.fill_holes = bool(fill_holes)

    @torch.no_grad()
    def _segment_all(self, images: torch.Tensor) -> torch.Tensor:
        """(F, 2, H, W) raw float on the device -> (F, H, W) int32 labels."""
        x = _normalize_percentile(images.permute(0, 2, 3, 1).to(torch.float32))
        pred = self.model(x)
        flows = _div(torch.stack([pred[..., 0], pred[..., 1]], dim=1), 5.0)
        return masks_from_flows(
            flows,
            pred[..., 2],
            cellprob_threshold=self.cellprob_threshold,
            n_iter=self.flow_iters,
            max_labels=self.max_labels,
            min_size=self.min_size,
            flow_threshold=self.flow_threshold,
            fill_holes=self.fill_holes,
        )

    def segment_tiles(self, images: np.ndarray) -> list[np.ndarray]:
        """(F, 2, Y, X) float -> list of (Y, X) uint16 label maps."""
        padded, (H, W) = _pad_to_multiple(np.asarray(images, np.float32))
        labels = self._segment_all(torch.from_numpy(np.ascontiguousarray(padded)).to(self.device))
        out = labels.cpu().numpy()[:, :H, :W]
        return [_to_uint16(m) for m in out]


_ENGINE_CACHE: dict[tuple, CellposeTorch] = {}


def _freeze(v):
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    return v


def _get_engine(**kw) -> CellposeTorch:
    """Identical configurations share ONE engine, so every object that uses
    it can be segmented as one batch (:func:`segment_grouped`)."""
    kw["device"] = resolve_device(kw.get("device"))
    key = _freeze({**kw, "pretrained_path": str(kw.get("pretrained_path"))})
    if key not in _ENGINE_CACHE:
        _ENGINE_CACHE[key] = CellposeTorch(**kw)
    return _ENGINE_CACHE[key]


def _make_cellpose_segmenter(
    channel_to_segment: int = 0,
    second_channel: int | None = None,
    three_d: bool = False,
    stitch_threshold: float = 0.01,
    **kwargs,
):
    if three_d:
        raise NotImplementedError(
            "three_d=True stitches z planes with track/ (ROADMAP queue 1, item 9)"
        )
    del stitch_threshold
    engine = _get_engine(
        pretrained_path=kwargs.get("pretrained_path"),
        model_kwargs=kwargs.get("model_kwargs"),
        cellprob_threshold=kwargs.get("cellprob_threshold", 0.0),
        flow_iters=kwargs.get("flow_iters"),
        max_labels=kwargs.get("max_labels", 256),
        min_size=kwargs.get("min_size", 15),
        flow_threshold=kwargs.get("flow_threshold", 0.4),
        fill_holes=kwargs.get("fill_holes", True),
        device=kwargs.get("device"),
    )

    def _channel(pixels, channel):
        sel = pixels[:, channel]  # (F, Z, Y, X)
        return sel.max(axis=1) if sel.shape[1] > 1 else sel[:, 0]

    def images(pixels) -> np.ndarray:
        """(F, C, Z, Y, X) -> the (F, 2, Y, X) engine input (Z max-projected)."""
        pixels = _drop_leading_time(np.asarray(pixels)).astype(np.float32)
        main = _channel(pixels, channel_to_segment)
        sec = _channel(pixels, second_channel) if second_channel is not None \
            else np.zeros_like(main)
        return np.stack([main, sec], axis=1)

    def segment(pixels, **_ignored):
        return engine.segment_tiles(images(pixels))

    segment.engine = engine
    segment.images = images
    return segment


def segment_grouped(segmenters, pixels) -> list[list[np.ndarray]]:
    """Segment one (F, C, Z, Y, X) stack with several segmenters; those that
    share an engine run as ONE batch (the fused step's grouping,
    ``aliby_tpu/engine/fused.py``). Returns each segmenter's masks."""
    groups: dict[int, list[int]] = {}
    for i, seg in enumerate(segmenters):
        groups.setdefault(id(seg.engine), []).append(i)
    out: list = [None] * len(segmenters)
    for members in groups.values():
        imgs = [segmenters[i].images(pixels) for i in members]
        masks = segmenters[members[0]].engine.segment_tiles(np.concatenate(imgs))
        F = imgs[0].shape[0]
        for k, i in enumerate(members):
            out[i] = masks[k * F : (k + 1) * F]
    return out


_NOT_PORTED = {
    "threshold": "the threshold segmenter needs ops/edt and the rest of ops/labels "
                 "(ROADMAP queue 1, item 6)",
    "baby": "models/baby.py (ROADMAP queue 1, item 10)",
    "spots": "models/spots.py (ROADMAP queue 1, item 10)",
    "spotiflow": "models/spots.py (ROADMAP queue 1, item 10)",
}


def dispatch_segmenter(kind: str = "cellpose", channel_to_segment: int = 0, **kwargs):
    if kind in ("cellpose", "cellpose_tpu"):
        return _make_cellpose_segmenter(channel_to_segment, **kwargs)
    if kind in _NOT_PORTED:
        raise NotImplementedError(f"segmenter kind {kind!r}: {_NOT_PORTED[kind]}")
    if kind.startswith("nahual"):
        raise NotImplementedError(
            f"segmenter kind {kind!r}: the remote clients of net/ are not ported "
            "(ROADMAP queue 1, item 10)"
        )
    raise ValueError(f"Unknown segmenter kind {kind!r}")
