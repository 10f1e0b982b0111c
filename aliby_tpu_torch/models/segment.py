"""Segmenter dispatch (counterpart of ``aliby_tpu/models/segment.py``).

``dispatch_segmenter(kind, channel_to_segment, ...)`` returns
``segment(pixels) -> masks`` where ``pixels`` is ``(F, C, Z, Y, X)`` (a
leading T of size 1 is dropped) and ``masks`` is a list of per-tile 2-D
uint16 label maps. Kinds, on ``cuda`` unless ``device="cpu"`` is passed:

- ``cellpose``: percentile normalisation, the network (the U-Net with the
  bundled weights, or the CPnet graph of a torch Cellpose checkpoint
  passed as ``pretrained_path``) and mask reconstruction; with
  ``three_d=True`` each z plane is segmented and the planes are stitched;
- ``threshold``: Gaussian blur, Otsu, EDT-peak seeds and nearest-seed
  regions, connected components for seedless blobs, the size filter; all
  tiles of a call as one batch;
- ``baby``: :mod:`aliby_tpu_torch.models.baby` (layered masks, tracking and
  lineage) on a base segmenter;
- ``spots`` / ``spotiflow``: :mod:`aliby_tpu_torch.models.spots`;
- ``nahual_<group>`` (``nahual_cellpose``, ``nahual_baby``,
  ``nahual_spotiflow``, ...): a client of a model server
  (:mod:`aliby_tpu_torch.net`) at ``address``; the model runs on the
  server's device.
"""

from __future__ import annotations

import warnings
from pathlib import Path

import numpy as np
import torch

from aliby_tpu_torch.device import resolve_device
from aliby_tpu_torch.models.cpnet import load_cellpose_checkpoint
from aliby_tpu_torch.models.flows import _div, masks_from_flows
from aliby_tpu_torch.models.unet import CellposeNet
from aliby_tpu_torch.models.weights import (
    BUNDLED_WEIGHTS,
    params_from_flax,
    read_flax_checkpoint,
)
from aliby_tpu_torch.ops.edt import edt_to_other_label, nearest_seed
from aliby_tpu_torch.ops.imageops import (
    gaussian_blur,
    otsu_threshold,
    peak_local_max,
    percentile_pair,
)
from aliby_tpu_torch.ops.labels import (
    connected_components,
    relabel_sequential,
    relabel_sequential_batched,
    segment_sum,
)
from aliby_tpu_torch.track.trackers import stitch_sequence
from aliby_tpu_torch.utils.profiling import span


UNET_BATCH_PIXELS = 1 << 20  # pixels in one U-Net forward (the micro-batch)


def _to_uint16(mask: np.ndarray) -> np.ndarray:
    if mask.max() > np.iinfo(np.uint16).max:
        raise ValueError("Label overflow: >65535 objects in one tile.")
    return mask.astype(np.uint16)


def _drop_leading_time(pixels: np.ndarray) -> np.ndarray:
    if pixels.ndim == 6:
        pixels = pixels[0]
    return pixels


# ---------------------------------------------------------------------------
# threshold segmenter
# ---------------------------------------------------------------------------


def threshold_segment(imgs: torch.Tensor, min_distance: int = 8, max_labels: int = 256,
                      min_size: int = 20, threshold_scale: float = 1.0) -> torch.Tensor:
    """(B, H, W) images -> (B, H, W) int32 labels 1..n, each image as the
    reference's ``_threshold_segment_2d``: blur (sigma 1.5), Otsu scaled by
    ``threshold_scale``, EDT peaks at least ``min_distance`` apart as seeds,
    each foreground pixel to its nearest seed, connected components for
    blobs no seed reached, then objects below ``min_size`` pixels dropped."""
    B, H, W = imgs.shape
    dev = imgs.device
    smoothed = gaussian_blur(imgs.to(torch.float32), 1.5)
    scale = torch.tensor(float(threshold_scale), dtype=torch.float32, device=dev)
    thr = otsu_threshold(smoothed) * scale
    mask = smoothed > thr.reshape(B, 1, 1)
    dist = edt_to_other_label(mask.to(torch.int32))
    coords, valid = peak_local_max(dist, min_distance=min_distance, threshold=1.0,
                                   max_peaks=max_labels)
    flat_idx = (coords[..., 0].to(torch.int64) * W + coords[..., 1]).clamp(0, H * W - 1)
    seed_map = torch.zeros(B, H * W, dtype=torch.bool, device=dev)
    seed_map.scatter_(1, flat_idx, valid)
    sy, sx = nearest_seed(seed_map.reshape(B, H, W))
    seed_ids = torch.cumsum(seed_map, dim=1, dtype=torch.int32)  # 1..n at the seeds
    at = (sy.clamp(0, H - 1).to(torch.int64) * W + sx.clamp(0, W - 1)).reshape(B, -1)
    lbl = torch.gather(seed_ids, 1, at).reshape(B, H, W)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    labels = torch.where(mask & (sy > -(2 ** 20)), lbl, zero)
    cc = connected_components(mask & (labels == 0))
    top = labels.reshape(B, -1).amax(dim=1).reshape(B, 1, 1)
    labels = torch.where(labels > 0, labels, torch.where(cc > 0, cc + top, zero))
    labels, _ = relabel_sequential_batched(labels, max_labels)
    areas = segment_sum(torch.ones(B, H * W, dtype=torch.float32, device=dev), labels,
                        max_labels)
    keep = torch.cat([torch.zeros(B, 1, dtype=torch.bool, device=dev), areas >= min_size], 1)
    keep_px = torch.gather(keep, 1, labels.reshape(B, -1).clamp(0, max_labels).to(torch.int64))
    labels = torch.where(keep_px.reshape(B, H, W), labels, zero)
    return relabel_sequential_batched(labels, max_labels)[0]


def _make_threshold_segmenter(channel_to_segment: int = 0, device=None, **kwargs):
    seg_kwargs = {k: kwargs[k] for k in ("min_distance", "max_labels", "min_size",
                                         "threshold_scale") if k in kwargs}
    device = resolve_device(device)

    def segment(pixels, **_ignored):
        pixels = _drop_leading_time(np.asarray(pixels))
        imgs = pixels[:, channel_to_segment]  # (F, Z, Y, X)
        imgs = imgs.max(axis=1) if imgs.shape[1] > 1 else imgs[:, 0]
        x = torch.from_numpy(np.ascontiguousarray(imgs, np.float32)).to(device)
        with torch.no_grad():
            labels = threshold_segment(x, **seg_kwargs).cpu().numpy()
        return [_to_uint16(m) for m in labels]

    segment.device = device
    return segment


def _normalize_percentile(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> each (image, channel) plane mapped by its exact 1st
    and 99th percentiles: (x - lo) / max(hi - lo, 1e-6)."""
    B, H, W, C = x.shape
    with span("seg.normalize", device=x.device):
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
    """Normalise + network forward + flow reconstruction. The network is the
    flagship U-Net with the weights of the JAX package's flax checkpoints,
    or, for a torch Cellpose checkpoint (``.pt``/``.pth``, ``torch`` in the
    file name, or ``model_kwargs={"arch": "cpnet"}``), the CPnet graph of
    :mod:`aliby_tpu_torch.models.cpnet` (``model_kwargs``: ``nbase``,
    ``nout``, ``sz``, ``dtype``)."""

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
        self.device = resolve_device(device)
        torch_ckpt = pretrained_path is not None and (
            arch == "cpnet"
            or str(pretrained_path).endswith((".pt", ".pth"))
            or "torch" in Path(pretrained_path).name
        )
        if torch_ckpt:
            # a published torch Cellpose checkpoint: the CPnet graph
            self.model = load_cellpose_checkpoint(pretrained_path, **model_kwargs)
        else:
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
        # 2 Euler steps, validated for the bundled/flax training pipeline;
        # torch Cellpose checkpoints keep the reference's conservative 8
        if flow_iters is None:
            flow_iters = 8 if torch_ckpt else 2
        self.flow_iters = int(flow_iters)
        self.cellprob_threshold = float(cellprob_threshold)
        self.max_labels = int(max_labels)
        self.min_size = int(min_size)
        self.flow_threshold = None if flow_threshold is None else float(flow_threshold)
        self.fill_holes = bool(fill_holes)

    def _forward(self, x: torch.Tensor) -> torch.Tensor:
        """The U-Net over (B, H, W, C) in micro-batches whose size follows
        the image size alone (``UNET_BATCH_PIXELS`` pixels, 1 to 16 images),
        the last one padded with zero images. On the card the U-Net's output
        bits depend on the batch size (the rest of the step does not:
        ``scripts/torch_batch_identity.py``), and an image's labels must not
        depend on how many images it is batched with, so that the per-tp,
        movie and mesh runners give the same bits."""
        B, H, W, _ = x.shape
        m = max(1, min(16, UNET_BATCH_PIXELS // (H * W)))
        pad = (-B) % m
        with span("seg.network", device=x.device):
            if pad:
                x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
            outs = []
            for i in range(0, B + pad, m):
                out = self.model(x[i:i + m])
                outs.append(out[0] if isinstance(out, tuple) else out)  # CPnet: (out, style)
            return torch.cat(outs)[:B]

    @torch.no_grad()
    def _segment_all(self, images: torch.Tensor) -> torch.Tensor:
        """(F, 2, H, W) raw float on the device -> (F, H, W) int32 labels."""
        x = _normalize_percentile(images.permute(0, 2, 3, 1).to(torch.float32))
        pred = self._forward(x)
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


def _segment_3d(engine, pixels: np.ndarray, channel: int, second_channel: int | None,
                stitch_threshold: float) -> list[np.ndarray]:
    """The reference's 3-D semantics (``segment/dispatch.py:214-247``):
    segment each z plane, IoU-stitch the labels across z, max-project to one
    2-D label map and relabel it sequentially."""
    main_z = pixels[:, channel]  # (F, Z, Y, X)
    sec_z = pixels[:, second_channel] if second_channel is not None else np.zeros_like(main_z)
    out = []
    for f in range(main_z.shape[0]):
        z_masks = engine.segment_tiles(np.stack([main_z[f], sec_z[f]], axis=1))  # (Z, 2, Y, X)
        stitched = stitch_sequence(
            torch.from_numpy(np.stack(z_masks).astype(np.int32)).to(engine.device),
            max_labels=engine.max_labels, iou_threshold=stitch_threshold)
        relab, _ = relabel_sequential(stitched.amax(dim=0), engine.max_labels)
        out.append(_to_uint16(relab.cpu().numpy()))
    return out


def _make_cellpose_segmenter(
    channel_to_segment: int = 0,
    second_channel: int | None = None,
    three_d: bool = False,
    stitch_threshold: float = 0.01,
    **kwargs,
):
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
        pixels = _drop_leading_time(np.asarray(pixels)).astype(np.float32)
        if three_d and pixels.shape[2] > 1:
            return _segment_3d(engine, pixels, channel_to_segment, second_channel,
                               stitch_threshold)
        return engine.segment_tiles(images(pixels))

    segment.engine = engine
    segment.images = images
    segment.three_d = three_d
    return segment


def segment_grouped(segmenters, pixels) -> list[list[np.ndarray]]:
    """Segment one (F, C, Z, Y, X) stack with several segmenters; those that
    share an engine run as ONE batch (the fused step's grouping,
    ``aliby_tpu/engine/fused.py``). Returns each segmenter's masks."""
    groups: dict[int, list[int]] = {}
    out: list = [None] * len(segmenters)
    for i, seg in enumerate(segmenters):
        if seg.three_d:  # z planes stitched one field at a time
            out[i] = seg(pixels)
        else:
            groups.setdefault(id(seg.engine), []).append(i)
    for members in groups.values():
        imgs = [segmenters[i].images(pixels) for i in members]
        masks = segmenters[members[0]].engine.segment_tiles(np.concatenate(imgs))
        F = imgs[0].shape[0]
        for k, i in enumerate(members):
            out[i] = masks[k * F : (k + 1) * F]
    return out


def dispatch_segmenter(kind: str = "cellpose", channel_to_segment: int = 0, **kwargs):
    if kind in ("cellpose", "cellpose_tpu"):
        return _make_cellpose_segmenter(channel_to_segment, **kwargs)
    if kind == "threshold":
        return _make_threshold_segmenter(channel_to_segment, **kwargs)
    if kind == "baby":
        from aliby_tpu_torch.models.baby import make_baby_segmenter

        return make_baby_segmenter(channel_to_segment, **kwargs)
    if kind in ("spots", "spotiflow"):
        from aliby_tpu_torch.models.spots import make_spot_segmenter

        return make_spot_segmenter(channel_to_segment, **kwargs)
    if kind.startswith("nahual"):
        from aliby_tpu_torch.net.client import make_remote_segmenter

        kwargs.pop("device", None)  # the model runs where its server runs
        return make_remote_segmenter(kind, channel_to_segment=channel_to_segment, **kwargs)
    raise ValueError(f"Unknown segmenter kind {kind!r}")
