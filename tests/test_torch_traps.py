"""Trap detection's primitives, ``tile/traps.py`` and the trap tiler of the
port against the JAX package's, on the CPU.

Exact: binary dilation, erosion and closing; ``clear_border`` on raw
connected-component ids above 4,096 (its presence table has H * W + 1
bins); the trap centres of ``segment_traps`` on a 256 x 256 trap field at
tile size 40 (clean and degraded); the tiler's grid, drift records and
tile blocks.

Within a tolerance, with its reason:
- ``resize_bilinear``: JAX's antialiased weights (a triangle widened by
  the inverse scale when downscaling) within 1e-6 absolute (weights lie
  in [0, 1]; XLA folds them at compile time in its own arithmetic: at
  256 -> 102 a few entries differ, by at most 6.6e-7; the upscales are
  exact); the resized image within 1e-6 of its largest value.
  ``F.interpolate`` without ``antialias=True`` is shown to be another
  function at the 0.4 downscale the detector uses.
- ``entropy_filter``: atol 1e-5 bits (``log2`` and the 32-level sum round
  differently; the counts are exact integers).
- ``fft_correlate_same`` and ``match_template``: two f32 FFTs (XLA's and
  pocketfft) each differ from a float64 NCC by more than 1e-5 on this
  field, so the port is held to JAX at atol 2e-4 and both to the float64
  NCC at atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aliby_tpu.ops import imageops as JI
from aliby_tpu.ops import labels as JLab
from aliby_tpu.tile import tiler as jax_tiler
from aliby_tpu.tile.traps import segment_traps as jax_segment_traps
from aliby_tpu_torch.ops import imageops as I
from aliby_tpu_torch.ops import labels as Lab
from aliby_tpu_torch.test_data import render_trap_field
from aliby_tpu_torch.tile import tiler
from aliby_tpu_torch.tile.traps import TrapDetectionError, segment_traps

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("connectivity", [1, 2])
def test_binary_morphology_exact(connectivity):
    m = np.random.default_rng(connectivity).random((2, 40, 33)) > 0.7
    for n in (1, 3):
        got = I.binary_dilation(_t(m), n, connectivity).numpy()
        got_e = I.binary_erosion(_t(m), n, connectivity).numpy()
        for b in range(2):
            np.testing.assert_array_equal(got[b], np.asarray(
                JI.binary_dilation(jnp.asarray(m[b]), n, connectivity)))
            np.testing.assert_array_equal(got_e[b], np.asarray(
                JI.binary_erosion(jnp.asarray(m[b]), n, connectivity)))
    got_c = I.binary_closing(_t(m), 2).numpy()
    for b in range(2):
        np.testing.assert_array_equal(got_c[b], np.asarray(JI.binary_closing(jnp.asarray(m[b]), 2)))


def test_clear_border_raw_ids_above_4096():
    m = np.random.default_rng(0).random((96, 96)) > 0.5
    cc = np.asarray(JLab.connected_components(jnp.asarray(m), connectivity=2))
    assert cc.max() > 4096
    np.testing.assert_array_equal(
        Lab.connected_components(_t(m[None]), connectivity=2).numpy()[0], cc)
    got = I.clear_border(_t(cc[None])).numpy()[0]
    want = np.asarray(JI.clear_border(jnp.asarray(cc)))
    np.testing.assert_array_equal(got, want)
    assert (want > 4096).any()  # large ids survive away from the border


@pytest.mark.parametrize("shape", [(256, 102), (102, 256), (20, 40), (41, 16)])
def test_resize_weights(shape):
    from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

    a, b = shape
    # inside jit, as resize_bilinear runs it: XLA folds the constant weights
    want = np.asarray(jax.jit(
        lambda: compute_weight_mat(a, b, b / a, 0.0, _fill_triangle_kernel, True))())
    got = I.resize_weights(a, b)
    assert np.abs(got - want).max() <= 1e-6
    if b > a:
        np.testing.assert_array_equal(got, want)


def test_resize_bilinear_is_antialiased():
    img, _ = render_trap_field(size=256, spacing=60, seed=3)
    for out in ((102, 102), (256, 256), (300, 280)):
        want = np.asarray(JI.resize_bilinear(jnp.asarray(img), out))
        got = I.resize_bilinear(_t(img[None]), out).numpy()[0]
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    plain = torch.nn.functional.interpolate(_t(img[None, None]), size=(102, 102),
                                            mode="bilinear", align_corners=False)[0, 0].numpy()
    want = np.asarray(JI.resize_bilinear(jnp.asarray(img), (102, 102)))
    assert np.abs(plain - want).max() > 1.0


def test_entropy_filter():
    img, _ = render_trap_field(size=128, spacing=60, seed=2)
    for radius in (2, 5):
        got = I.entropy_filter(_t(img[None]), radius=radius).numpy()[0]
        want = np.asarray(JI.entropy_filter(jnp.asarray(img), radius=radius))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _ncc64(img, t):
    img, t = img.astype(np.float64), t.astype(np.float64)
    (H, W), (h, w) = img.shape, t.shape
    fh, fw = H + h - 1, W + w - 1

    def corr(a, k):
        full = np.fft.irfft2(np.fft.rfft2(a, (fh, fw)) * np.fft.rfft2(k[::-1, ::-1], (fh, fw)),
                             (fh, fw))
        return full[(h - 1) // 2:(h - 1) // 2 + H, (w - 1) // 2:(w - 1) // 2 + W]

    t0 = t - t.mean()
    ones = np.ones_like(t)
    s1, s2 = corr(img, ones), corr(img ** 2, ones)
    den = np.sqrt(np.maximum(s2 - s1 ** 2 / t.size, 0) * max((t0 ** 2).sum(), 1e-12))
    return corr(img, t0) / np.maximum(den, 1e-8) * (den > 1e-8)


def test_fft_correlation_and_match_template():
    img, _ = render_trap_field(size=256, spacing=60, seed=3)
    tpl = img[40:60, 40:60].copy()
    got = I.fft_correlate_same(_t(img[None]), _t(tpl)).numpy()[0]
    want = np.asarray(JI.fft_correlate_same(jnp.asarray(img), jnp.asarray(tpl)))
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    got = I.match_template(_t(img[None]), _t(tpl)).numpy()[0]
    want = np.asarray(JI.match_template(jnp.asarray(img), jnp.asarray(tpl)))
    ref = _ncc64(img, tpl)
    assert np.abs(got - want).max() <= 2e-4
    assert np.abs(got - ref).max() <= 1e-4 and np.abs(want - ref).max() <= 1e-4
    assert np.abs(want - ref).max() > 1e-5  # why 1e-5 between the two cannot hold


@pytest.mark.parametrize("degr", [{}, dict(illumination=0.25, defocus=1.0, n_debris=8,
                                           occupancy=0.5)], ids=["clean", "combined"])
def test_segment_traps_centres_equal(degr):
    img, truth = render_trap_field(size=256, spacing=60, seed=3, **degr)
    got = segment_traps(img, tile_size=40, min_traps=10, device="cpu")
    want = np.asarray(jax_segment_traps(img, tile_size=40, min_traps=10))
    np.testing.assert_array_equal(got, want)
    assert len(got) >= 0.7 * len(truth)


class _Img:
    def __init__(self, data):
        self.data = data
        self.meta = {}


def test_trap_tiler_grid_and_drift():
    frames = [render_trap_field(size=256, spacing=60, seed=11, drift=d)[0]
              for d in ((0.0, 0.0), (2.0, -3.0), (4.0, -5.0))]
    stack = np.stack(frames)[:, None, None]  # TCZYX
    t = tiler.dispatch_tiler(tile_size=40, track_drift=True, device="cpu")(_Img(stack))
    jt = jax_tiler.dispatch_tiler(tile_size=40, track_drift=True)(_Img(stack))
    for tp in range(3):
        got, want = t.run_tp(tp), jt.run_tp(tp)
        assert got["drift"].keys() == want["drift"].keys()
        for k in want["drift"]:
            np.testing.assert_array_equal(np.asarray(got["drift"][k]), np.asarray(want["drift"][k]))
        np.testing.assert_array_equal(got["pixels"], want["pixels"])
    assert t.n_tiles == jt.n_tiles > 6
    np.testing.assert_array_equal(t.tile_locs.initial_centres, jt.tile_locs.initial_centres)


def test_trap_tiler_falls_back_to_one_centred_tile():
    flat = np.random.default_rng(0).normal(100, 1, (1, 1, 1, 96, 96)).astype(np.float32)
    t = tiler.dispatch_tiler(tile_size=40, track_drift=False, device="cpu")(_Img(flat))
    jt = jax_tiler.dispatch_tiler(tile_size=40, track_drift=False)(_Img(flat))
    got, want = t.run_tp(0), jt.run_tp(0)
    assert t.n_tiles == jt.n_tiles == 1
    np.testing.assert_array_equal(got["pixels"], want["pixels"])
    with pytest.raises(TrapDetectionError):
        segment_traps(flat[0, 0, 0], tile_size=40, device="cpu")


def trap_movie(T: int, seed: int, cells: str, size: int = 256, spacing: int = 64,
               trap: int = 22) -> np.ndarray:
    """The trap fields of ``tests/test_trap_pipeline.py`` at 256 x 256 (a 3 x
    3 grid of U-shaped traps with a cell in each): ``cells="gauss"`` is its
    single-tp field (Gaussian cells), ``"ellipse"`` its drifting T-tp movie
    (ellipse-profile cells moving 1 px a tp). (T, C=2, Z=1, Y, X) f32."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    n = (size - 48) // spacing
    frames = []
    for t in range(T):
        img = rng.normal(100, 3, (size, size)).astype(np.float32)
        fluo = (rng.normal(5, 0.5, (size, size)) if cells == "ellipse"
                else rng.normal(50, 2, (size, size))).astype(np.float32)
        for i in range(n):
            for j in range(n):
                cy, cx = 48 + spacing // 2 + i * spacing, 48 + spacing // 2 + j * spacing
                h = trap // 2
                img[cy - h:cy + h, cx - h:cx - h + 4] += 90
                img[cy - h:cy + h, cx + h - 4:cx + h] += 90
                img[cy + h - 4:cy + h, cx - h:cx + h] += 90
                if cells == "ellipse":
                    d2 = ((xx - (cx - t)) / 9.0) ** 2 + ((yy - (cy + t)) / 7.0) ** 2
                    fluo += 200 * np.clip(1.2 - d2, 0, None)
                else:
                    fluo += 400 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 5.0 ** 2))
        frames.append(np.stack([img, fluo]))
    return np.stack(frames)[:, :, None].astype(np.float32)


def trap_pipeline(store, key: str, segmenter_kwargs: dict, **extra) -> dict:
    """The pipeline of ``tests/test_trap_pipeline.py``: trap tiles of 64,
    the segmenter on channel 1, cellfuns ``area`` and ``mean``."""
    pipe = {
        "steps": {
            "tile": {"tile_size": 64, "track_drift": False,
                     "image_kwargs": {"source": {"key": key, "path": str(store)},
                                      "capture_order": "TCZYX"}},
            "segment_cell": {"segmenter_kwargs": segmenter_kwargs, "channel_to_segment": 1},
            "extract_cell": {"tree": {"None": {"None": ["area"]}, 1: {"max": ["mean"]}},
                             "kwargs": {}},
        },
        "passed_data": {"extract_cell": [("masks", "segment_cell"), ("pixels", "tile")]},
        "passed_methods": {"segment_cell": ("tile", "get_fczyx")},
        "save": ["segment_cell"],
        "save_interval": 1,
    }
    pipe.update(extra)
    return pipe


def assert_same_tables(got, want):
    """Port vs JAX profile or tracking tables: equal names and values
    (these columns are integers or exactly computed)."""
    assert got.column_names == want.column_names and got.num_rows == want.num_rows > 0
    for name in want.column_names:
        assert got.column(name).to_pylist() == want.column(name).to_pylist(), name


def test_trap_pipeline_multitile_interpreted(tmp_path):
    """``tests/test_trap_pipeline.py::test_trap_pipeline_multitile`` through
    the port: trap tiles, the threshold segmenter (interpreted), cellfuns."""
    from aliby_tpu.pipe import run_pipeline_and_post as jax_run
    from aliby_tpu_torch.io import zarrlite
    from aliby_tpu_torch.pipe import run_pipeline_and_post

    zarrlite.write_array(tmp_path / "posT", trap_movie(1, 2, "gauss"))
    seg = {"kind": "threshold", "threshold_scale": 0.8, "min_size": 10}
    got, _ = run_pipeline_and_post(trap_pipeline(tmp_path / "posT", "posT", seg), "posT",
                                   tmp_path / "port", overwrite=True, device="cpu")
    want, _ = jax_run(pipeline=trap_pipeline(tmp_path / "posT", "posT", seg),
                      pipeline_name="posT", output_path=tmp_path / "jax", overwrite=True)
    assert_same_tables(got, want)
    assert len(set(got.column("metadata_tile").to_pylist())) == 9
    assert all(a >= 10 for a in got.column("None/None/area/area").to_pylist())
    seg_dir = "steps/posT/segment_cell"
    for f in sorted((tmp_path / "jax" / seg_dir).glob("*.npz")):
        with np.load(f) as b, np.load(tmp_path / "port" / seg_dir / f.name) as a:
            assert a["arr_0"].shape[1:] == (64, 64)
            np.testing.assert_array_equal(a["arr_0"], b["arr_0"])
