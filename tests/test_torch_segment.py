"""Port parity: the segmentation step end to end
(``aliby_tpu_torch.models.segment``) against ``aliby_tpu.models.segment``.

- Mask reconstruction on network-predicted flows (the field of
  ``test_dynamics_predicted.py``, flows from the bundled weights): labels
  bit-equal, QC on and off.
- The whole ``dispatch_segmenter("cellpose")`` closure on a 2-field,
  5-channel, 128x128 ``render_cells`` block with the bundled weights, f32
  model on both sides: equal object counts and matched IoU >= 0.99 (both
  directions) is the gate; the labels are also bit-equal on this block.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aliby_tpu.models.flows import masks_from_flows as jax_masks_from_flows
from aliby_tpu.models.segment import dispatch_segmenter as jax_dispatch
from aliby_tpu.test_data import render_cells, render_dense_cells
from aliby_tpu_torch.device import resolve_device
from aliby_tpu_torch.models import segment as S
from aliby_tpu_torch.models.flows import masks_from_flows
from test_dynamics_parity import matched_iou

torch.set_num_threads(1)
F32 = {"dtype": torch.float32}


def _predicted_field():
    # test_dynamics_predicted.py's field: soft interiors plus noise
    rng = np.random.default_rng(21)
    gt = render_dense_cells(192, 36, rng, 5.0, 12.0)
    prof = np.zeros(gt.shape, np.float32)
    for i in range(1, int(gt.max()) + 1):
        sel = gt == i
        if not sel.any():
            continue
        ys, xs = np.nonzero(sel)
        cy, cx = ys.mean(), xs.mean()
        r = max(np.hypot(ys - cy, xs - cx).max(), 1.0)
        d = np.hypot(np.arange(192)[:, None] - cy, np.arange(192)[None, :] - cx)
        prof = np.where(sel, np.clip(1.2 - (d / r) ** 2, 0.05, None), prof)
    return prof + rng.normal(0, 0.03, gt.shape).astype(np.float32)


@pytest.mark.parametrize("flow_threshold", [None, 0.4])
def test_masks_from_predicted_flows(flow_threshold):
    img = _predicted_field()
    engine = S.CellposeTorch(model_kwargs=F32, device="cpu")
    x = torch.from_numpy(np.stack([img, np.zeros_like(img)], axis=-1))[None]
    with torch.no_grad():
        pred = engine.model(S._normalize_percentile(x))[0].numpy()
    flows = (np.stack([pred[..., 0], pred[..., 1]]) / np.float32(5.0)).astype(np.float32)
    cellprob = pred[..., 2].copy()
    assert (cellprob > 0).sum() > 2000
    want = np.asarray(jax_masks_from_flows(
        flows, cellprob, max_labels=512, flow_threshold=flow_threshold))
    got = masks_from_flows(torch.from_numpy(flows)[None], torch.from_numpy(cellprob)[None],
                           max_labels=512, flow_threshold=flow_threshold).numpy()[0]
    assert want.max() >= 10
    np.testing.assert_array_equal(got, want)


def _block():
    rng = np.random.default_rng(3)
    fields = []
    for _ in range(2):
        cells, nuclei, _ = render_cells(128, 10, rng)
        noise = lambda: rng.normal(0.02, 0.01, (128, 128)).astype(np.float32)  # noqa: E731
        ring = np.clip(cells - nuclei, 0, None)
        fields.append(np.stack([nuclei + noise(), ring + noise(),
                                0.5 * nuclei + 0.5 * cells + noise(),
                                cells + noise(), ring * 0.8 + noise()]))
    return np.stack(fields)[:, :, None]  # (F, C, Z, Y, X)


def test_segment_closure_matches_jax():
    pixels = _block()
    want = jax_dispatch("cellpose", 0, second_channel=3,
                        model_kwargs={"dtype": jnp.float32})(pixels)
    seg = S.dispatch_segmenter("cellpose", 0, second_channel=3, model_kwargs=F32, device="cpu")
    got = seg(pixels[None])  # a leading T of size 1 is dropped
    assert len(got) == len(want) == 2
    for a, b in zip(want, got):
        assert b.dtype == np.uint16 and b.shape == (128, 128)
        assert a.max() == b.max() >= 5
        assert matched_iou(a.astype(np.int64), b.astype(np.int64)) >= 0.99
        assert matched_iou(b.astype(np.int64), a.astype(np.int64)) >= 0.99
        np.testing.assert_array_equal(a, b)


def test_engine_shared_and_grouped_batch():
    pixels = _block()
    nuclei = S.dispatch_segmenter("cellpose", 0, second_channel=3, model_kwargs=F32,
                                  device="cpu")
    cell = S.dispatch_segmenter("cellpose", 3, second_channel=0, model_kwargs=F32,
                                device="cpu")
    assert nuclei.engine is cell.engine
    grouped = S.segment_grouped([nuclei, cell], pixels)
    for seg, masks in zip((nuclei, cell), grouped):
        for a, b in zip(seg(pixels), masks):
            np.testing.assert_array_equal(a, b)


def test_padding_and_uint16():
    img = np.arange(2 * 3 * 10 * 13, dtype=np.float32).reshape(2, 3, 10, 13)
    padded, hw = S._pad_to_multiple(img)
    assert padded.shape == (2, 3, 16, 16) and hw == (10, 13)
    np.testing.assert_array_equal(padded[..., :10, :13], img)
    with pytest.raises(ValueError):
        S._to_uint16(np.array([70000]))


def test_dispatch_kinds_and_devices():
    assert S.dispatch_segmenter("threshold", device="cpu").device == torch.device("cpu")
    assert callable(S.dispatch_segmenter("baby", device="cpu"))
    with pytest.raises(ValueError, match="requires an 'address'"):
        S.dispatch_segmenter("nahual_cellpose")
    assert S.dispatch_segmenter("spots", device="cpu").device == torch.device("cpu")
    assert S.dispatch_segmenter("cellpose", three_d=True, device="cpu").three_d
    with pytest.raises(FileNotFoundError, match="model_torch.pth"):
        S.CellposeTorch(pretrained_path="model_torch.pth", device="cpu")
    with pytest.raises(ValueError):
        S.dispatch_segmenter("no-such-kind")
    assert resolve_device("cpu") == torch.device("cpu")


def test_cuda_is_the_default_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        S.CellposeTorch()
    with pytest.raises(RuntimeError, match="CUDA"):
        S.dispatch_segmenter("cellpose")
