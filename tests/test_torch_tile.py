"""The port's tilers (``aliby_tpu_torch.tile``) against the JAX package's,
on the scenarios of ``tests/test_tile.py``: the mono tile, drift tracking
over timepoints (the host phase correlation, the drift records and the
tile blocks, equal), median padding, and ``CropTiler``'s grid with each
normalisation; equal arrays throughout. A ``tile_size`` on a ``Tiler``
runs trap detection (``tests/test_torch_traps.py`` holds it on trap
fields); on the yeast fixture, which has no traps, both packages give the
same tiles.
"""

import numpy as np
import pytest

from aliby_tpu.io.dataset import DatasetZarr
from aliby_tpu.io.image import ImageZarr as JaxImageZarr
from aliby_tpu.ops.imageops import phase_cross_correlation_host as jax_pcc
from aliby_tpu.test_data import get_dataset_path
from aliby_tpu.tile import tiler as jax_tiler
from aliby_tpu_torch.io.image import ImageZarr
from aliby_tpu_torch.ops.imageops import phase_cross_correlation_host
from aliby_tpu_torch.tile import tiler


def _images():
    pos = DatasetZarr(get_dataset_path("yeast_zarr")).get_position_ids()[0]
    src = {"key": pos["key"], "path": pos["path"]}
    return ImageZarr(src, capture_order="TCZYX"), JaxImageZarr(src, capture_order="TCZYX")


def _same_records(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _same_records(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


@pytest.mark.parametrize("track_drift", [False, True])
def test_mono_tiler_with_and_without_drift(track_drift):
    img, jimg = _images()
    t = tiler.dispatch_tiler(tile_size=None, track_drift=track_drift)(img)
    jt = jax_tiler.dispatch_tiler(tile_size=None, track_drift=track_drift)(jimg)
    assert isinstance(t, tiler.Tiler)
    for tp in range(3):
        got, want = t.run_tp(tp), jt.run_tp(tp)
        assert set(got) == {"drift", "pixels"}
        np.testing.assert_array_equal(got["pixels"], want["pixels"])
        _same_records(got["drift"], want["drift"])
    assert got["pixels"].shape == (1, 3, 3, 293, 293)
    np.testing.assert_array_equal(t.tile_locs.centres_at_time(2), jt.tile_locs.centres_at_time(2))
    if track_drift:  # the fixture's content moves (+2, -1) a tp
        drift = np.asarray(got["drift"]["drift"])
        assert abs(drift[0] + 2) <= 1.2 and abs(drift[1] - 1) <= 1.2
        assert not np.allclose(t.tile_locs.centres_at_time(0), t.tile_locs.centres_at_time(1))


def test_phase_correlation_and_median_pad():
    rng = np.random.default_rng(4)
    a = rng.normal(size=(40, 52)).astype(np.float32)
    b = np.roll(a, (3, -5), axis=(0, 1))
    np.testing.assert_array_equal(phase_cross_correlation_host(a, b), jax_pcc(a, b))
    frame = np.full((2, 20, 20), 7.0, np.float32)
    frame[:, 5, 5] = 100.0
    for ys in (slice(-2, 8), slice(-9, 1), slice(3, 13), slice(15, 25)):
        got = tiler.crop_with_median_pad(frame, ys, slice(0, 10))
        np.testing.assert_array_equal(got, jax_tiler.crop_with_median_pad(frame, ys, slice(0, 10)))
    assert (tiler.crop_with_median_pad(frame, slice(-2, 8), slice(0, 10))[:, :2] == 7.0).all()
    assert np.isnan(tiler.crop_with_median_pad(frame, slice(-9, 1), slice(0, 10))).all()


@pytest.mark.parametrize("flags", [{}, {"standard_scale": False, "clip_outliers": True,
                                        "convert_8bit": True}])
def test_crop_tiler_grid(flags):
    img, jimg = _images()
    t = tiler.dispatch_tiler("crop", tile_size=64, track_drift=False, **flags)(img)
    jt = jax_tiler.dispatch_tiler("crop", tile_size=64, track_drift=False, **flags)(jimg)
    assert isinstance(t, tiler.CropTiler)
    got = t.run_tp(1)["pixels"]
    assert got.shape == (16, 3, 3, 64, 64)
    np.testing.assert_array_equal(got, jt.run_tp(1)["pixels"])
    np.testing.assert_array_equal(t.get_fczyx(0), jt.get_fczyx(0))


def test_trap_grid_is_not_ported():
    """Trap detection at tile size 117 on the yeast fixture (no traps): the
    port's tiles (detected or the centred fallback) are the JAX package's."""
    img, jimg = _images()
    t = tiler.dispatch_tiler(tile_size=117, track_drift=False, device="cpu")(img)
    jt = jax_tiler.dispatch_tiler(tile_size=117, track_drift=False)(jimg)
    got, want = t.run_tp(0), jt.run_tp(0)
    _same_records(got["drift"], want["drift"])
    np.testing.assert_array_equal(got["pixels"], want["pixels"])
    assert t.n_tiles == jt.n_tiles >= 1
    params = tiler.TilerParameters.default(tile_size=None)
    assert params.to_dict() == jax_tiler.TilerParameters.default(tile_size=None).to_dict()
