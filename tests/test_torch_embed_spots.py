"""Port parity: the embedder (``aliby_tpu_torch.models.embedder``), example
02's deep-embedding pipeline, and the spot detector
(``aliby_tpu_torch.models.spots``) against the JAX package.

Tolerances (``aliby_tpu_torch.extract.tolerances``):
- the embedder's projection: the random bits and the uniforms bit-equal to
  ``jax.random`` (threefry, partitionable); the normals within 4 ulp (XLA's
  ``erf_inv`` polynomial, reproduced here up to ``log1p``'s last bits);
- embeddings: in f32 atol 1e-5; in bf16 (the default) max |diff| <= 2e-3
  (the U-Net's bf16 style bound) and mean |diff| <= 2e-4;
- example 02's profiles: metadata and column names equal, ``X_*`` columns
  by the bf16 embedding rule;
- spots: coordinates, radii, validity and painted labels bit-equal.
"""

import os
import sys
from copy import deepcopy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aliby_tpu.models import spots as jax_spots
from aliby_tpu.models.embedder import make_embedder as jax_make_embedder
from aliby_tpu.models.segment import BUNDLED_WEIGHTS
from aliby_tpu.models.segment import dispatch_segmenter as jax_dispatch
from aliby_tpu_torch.extract.extract import extraction_columns, format_extraction
from aliby_tpu_torch.extract.tolerances import within_model_tolerance
from aliby_tpu_torch.models import embedder, spots
from aliby_tpu_torch.models.segment import dispatch_segmenter

sys.path.insert(0, str(Path(__file__).parent))

torch.set_num_threads(1)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    def key(x):
        i = x.astype(np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)

    return np.abs(key(a) - key(b))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_projection_bits(seed):
    key = jax.random.PRNGKey(seed + 1)
    shape = (256, 64)
    assert embedder.prng_key(seed + 1) == tuple(int(k) for k in np.asarray(key))
    np.testing.assert_array_equal(embedder.random_bits(embedder.prng_key(seed + 1), shape),
                                  np.asarray(jax.random.bits(key, shape)))
    lo = np.nextafter(np.float32(-1), np.float32(0))
    want_u = np.asarray(jax.random.uniform(key, shape, jnp.float32, lo, 1.0))
    got_u = embedder.uniform(embedder.prng_key(seed + 1), shape, lo, 1.0)
    np.testing.assert_array_equal(got_u.view(np.uint32), want_u.view(np.uint32))
    want_n = np.asarray(jax.random.normal(key, shape))
    assert _ulps(embedder.normal(seed + 1, shape), want_n).max() <= 4
    proj = embedder.style_projection(seed, 256, 64)
    assert _ulps(proj, np.asarray(jax.random.normal(key, shape) / np.sqrt(256))).max() <= 4


def test_erfinv_edges():
    x = np.array([-1.0, -0.999999, -0.5, 0.0, 0.25, 0.9999, 1.0], np.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    with np.errstate(divide="ignore"):
        got = embedder.erfinv_f32(x)
    np.testing.assert_array_equal(got[[0, -1]], want[[0, -1]])
    assert _ulps(got[1:-1], want[1:-1]).max() <= 4


def _tiles(n=5, z=2, size=64, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(100.0, 20.0, (n, 5, z, size, size)).astype(np.float32)


@pytest.mark.parametrize("dtype, dim, channels", [("bf16", 64, None), ("bf16", 16, [0, 2, 4]),
                                                  ("bf16", None, None), ("f32", 64, [1, 3])])
def test_make_embedder_matches_jax(dtype, dim, channels):
    tiles = _tiles()
    jkw, tkw = dict(dim=dim, channels=channels, seed=3), dict(dim=dim, channels=channels, seed=3)
    if dtype == "f32":
        jkw.update(model_kwargs={"dtype": jnp.float32}, pretrained=str(BUNDLED_WEIGHTS))
        tkw.update(model_kwargs={"dtype": torch.float32}, pretrained=str(BUNDLED_WEIGHTS))
    want = np.asarray(jax_make_embedder(**jkw)(tiles))
    got = embedder.make_embedder(device="cpu", **tkw)(tiles[None])  # a leading T of 1
    assert got.dtype == np.float32 and got.shape == want.shape == (5, dim or 256)
    assert within_model_tolerance(got, want, "embed" if dtype == "bf16" else dtype)


def test_embedder_options():
    tiles = _tiles(n=2, z=1, size=32)
    custom = dict(model_kwargs={"base_features": (8, 16)}, dim=4, device="cpu")
    a = embedder.make_embedder(seed=1, **custom)(tiles)
    assert a.shape == (2, 4)
    np.testing.assert_array_equal(a, embedder.make_embedder(seed=1, **custom)(tiles))
    state = torch.random.get_rng_state()
    embedder.make_embedder(seed=2, **custom)
    assert torch.equal(state, torch.random.get_rng_state())  # the caller's RNG untouched
    with pytest.raises(FileNotFoundError):
        embedder.make_embedder(pretrained="no/such/weights.msgpack", device="cpu")
    with pytest.raises(ValueError, match="Unknown embedder model"):
        embedder.make_embedder(model="dino", device="cpu")


def test_embedding_columns_match_jax():
    """An embedder's (F, dim) output as a profile table: the JAX package
    wraps it in ``engine.core._format_profile_table``."""
    from aliby_tpu.engine.core import _format_profile_table as jax_profile_table
    from aliby_tpu_torch.engine.core import _format_profile_table

    emb = np.random.default_rng(1).normal(size=(4, 12)).astype(np.float32)
    want = jax_profile_table("embed_cells", 2, emb)
    got = _format_profile_table("embed_cells", 2, emb)
    assert list(got) == want.column_names
    assert want.column_names[:4] == ["metadata_tile", "metadata_label", "X_0", "X_1"]
    for name in want.column_names:
        np.testing.assert_array_equal(got[name], want.column(name).to_numpy())
    table = format_extraction(emb)
    assert table.column_names[:2] == ["tile", "label"] and table.num_rows == 4
    assert list(extraction_columns(np.zeros((0, 3), np.float32))) == ["tile", "label"]
    assert _format_profile_table("embed_cells", 0, np.zeros((0, 3), np.float32)) is False


EXAMPLE02 = {
    "steps": {
        "tile": {"kind": "crop", "tile_size": 64, "track_drift": False, "standard_scale": True},
        "embed_cells": {"model": "style", "dim": 64},
    },
    "passed_data": {"embed_cells": [("pixels", "tile")]},
    "passed_methods": {},
    "save": [],
    "save_interval": 1,
}


def _example02(position):
    pipeline = deepcopy(EXAMPLE02)
    pipeline["steps"]["tile"]["image_kwargs"] = {
        "source": {"key": position["key"], "path": position["path"]}, "capture_order": "CYX"}
    return pipeline


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    names = ("ALIBY_TPU_FIXTURES", "ALIBY_TPU_TORCH_FIXTURES")
    saved = {k: os.environ.get(k) for k in names}
    for k in names:
        os.environ[k] = str(tmp_path_factory.mktemp(k.lower()))
    yield
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@pytest.mark.parametrize("name", ["cellpainting_zarr", "crop_cellpainting_256"])
def test_fixtures_are_the_jax_packages(fixtures, name):
    from aliby_tpu import test_data as jax_data
    from aliby_tpu_torch import test_data

    a, b = jax_data.get_dataset_path(name), test_data.get_dataset_path(name)
    assert a != b and test_data.get_dataset(name) == jax_data.get_dataset(name)
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert len(files) > 2
    assert files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    for f in files:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


def test_example02_matches_jax(fixtures, tmp_path):
    from aliby_tpu.io.dataset import DatasetZarr as JaxDatasetZarr
    from aliby_tpu.pipe import run_pipeline_and_post as jax_run
    from aliby_tpu.test_data import get_dataset_path as jax_dataset_path
    from aliby_tpu_torch.engine.core import profile_columns, run_pipeline_return_state
    from aliby_tpu_torch.io.dataset import DatasetZarr
    from aliby_tpu_torch.pipe import init_step, run_pipeline_and_post
    from aliby_tpu_torch.pipe_core import configure_logging
    from aliby_tpu_torch.test_data import get_dataset_path

    positions = DatasetZarr(get_dataset_path("cellpainting_zarr")).get_position_ids()
    jax_positions = JaxDatasetZarr(jax_dataset_path("cellpainting_zarr")).get_position_ids()
    assert [p["key"] for p in positions] == [p["key"] for p in jax_positions] == ["A01", "B02"]
    configure_logging(tmp_path / "log.txt")
    want, _ = jax_run(_example02(jax_positions[0]), "A01", tmp_path / "jax")
    got, _ = run_pipeline_and_post(_example02(positions[0]), "A01", tmp_path / "port",
                                   device="cpu")
    x_cols = [c for c in got.column_names if c.startswith("X_")]
    assert got.column_names == want.column_names and len(x_cols) == 64
    assert got.num_rows == want.num_rows == 16  # 4 x 4 crops of 64 of a 256^2 field
    for c in ("metadata_tile", "metadata_label", "metadata_object", "metadata_tp"):
        assert got.column(c).equals(want.column(c)), c
    x = np.stack([got.column(c).to_numpy() for c in x_cols])
    assert within_model_tolerance(x, np.stack([want.column(c).to_numpy() for c in x_cols]),
                                  "embed")
    # the state path (no pyarrow) gives the same columns
    state = run_pipeline_return_state(_example02(positions[0]), None, init_step, device="cpu")
    cols = profile_columns(state, _example02(positions[0]))
    assert list(cols) == got.column_names
    np.testing.assert_array_equal(np.stack([cols[c] for c in x_cols]), x)


def _blob_frames(n=3, size=128, blobs=220, seed=0):
    """Frames with more LoG maxima than ``max_spots``: ``blobs`` Gaussian
    spots of random width and brightness on noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    frames = []
    for _ in range(n):
        img = rng.normal(0.0, 0.05, (size, size))
        for _ in range(blobs):
            cy, cx = rng.uniform(2, size - 2, 2)
            s, a = rng.uniform(1.0, 3.2), rng.uniform(0.2, 1.0)
            img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
        frames.append(img.astype(np.float32))
    return np.stack(frames)


@pytest.mark.parametrize("kw", [dict(max_spots=64), dict(max_spots=512),
                                dict(sigmas=(1.0, 2.0), threshold_rel=0.1, min_distance=2,
                                     max_spots=128)])
def test_detect_and_paint_spots_match_jax(kw):
    frames = _blob_frames()
    coords, radii, valid = spots.detect_spots(torch.from_numpy(frames), **kw)
    labels = spots.paint_spots(frames.shape[1:], coords, radii, valid).numpy()
    jkw = {k: v for k, v in kw.items()}
    n_valid = []
    for f, frame in enumerate(frames):
        jc, jr, jv = jax_spots.detect_spots(jnp.asarray(frame), **jkw)
        jv = np.asarray(jv)
        np.testing.assert_array_equal(valid[f].numpy(), jv)
        np.testing.assert_array_equal(coords[f].numpy()[jv], np.asarray(jc)[jv])
        np.testing.assert_array_equal(radii[f].numpy()[jv], np.asarray(jr)[jv])
        want = np.asarray(jax_spots.paint_spots(jnp.asarray(frame), jc, jr, jv,
                                                max_spots=kw["max_spots"]))
        np.testing.assert_array_equal(labels[f], want)
        n_valid.append(int(jv.sum()))
    if kw["max_spots"] == 64:
        assert n_valid == [64] * len(frames)  # more candidates than max_spots
    assert min(n_valid) > 20


@pytest.mark.parametrize("size", [512, 1080])
def test_detect_spots_on_full_frames_against_jax(size):
    """The five channels of phase 7's 1080^2 movie (and their 512^2 crops).
    The frame's f32 mean and std round differently in XLA's CPU reduction
    and in the port's (float64, rounded once, so that the card gives the
    CPU's bits): near-equal peaks swap places, and a peak at the threshold
    or the ``max_spots`` cut can move (ROADMAP queue 3). Held to the rule
    for a bit that crosses a threshold: equal spot counts, matched IoU >=
    0.99 of the painted labels both ways. Readings: 1080^2, 2 of 5 frames
    with one spot moved (IoU >= 0.9993), labels renumbered on all 5;
    512^2, 1 of 5 (IoU 0.99875)."""
    from aliby_tpu_torch.test_data import cellpainting_movie
    from test_dynamics_parity import matched_iou

    frames = cellpainting_movie(1, 1, 1080, seed=19)[0, 0, :, 0, :size, :size]
    frames = np.ascontiguousarray(frames.astype(np.float32))
    coords, radii, valid = spots.detect_spots(torch.from_numpy(frames))
    labels = spots.paint_spots(frames.shape[1:], coords, radii, valid).numpy()
    for f, frame in enumerate(frames):
        jc, jr, jv = jax_spots.detect_spots(jnp.asarray(frame))
        want = np.asarray(jax_spots.paint_spots(jnp.asarray(frame), jc, jr, jv))
        n = int(np.asarray(jv).sum())
        assert int(valid[f].sum()) == n == labels[f].max() == want.max() > 80, f
        assert min(matched_iou(labels[f], want), matched_iou(want, labels[f])) >= 0.99, f


def test_flat_frame_has_no_spots():
    flat = np.zeros((1, 48, 48), np.float32)
    coords, radii, valid = spots.detect_spots(torch.from_numpy(flat), max_spots=16)
    jc, jr, jv = jax_spots.detect_spots(jnp.asarray(flat[0]), max_spots=16)
    assert not valid.any() and not np.asarray(jv).any()
    assert not spots.paint_spots((48, 48), coords, radii, valid).any()


@pytest.mark.parametrize("kind", ["spots", "spotiflow"])
def test_spot_segmenter_matches_jax(kind):
    frames = _blob_frames(n=2, size=96, blobs=60, seed=4)
    pixels = np.stack([frames, 0.5 * frames], axis=1)[:, :, None]  # (F, C, Z, Y, X)
    pixels = np.concatenate([pixels, 0.9 * pixels], axis=2)  # two z planes
    kw = dict(sigmas=(1.5, 2.5), max_spots=128)
    want = jax_dispatch(kind, channel_to_segment=1, **kw)(pixels)
    got = dispatch_segmenter(kind, channel_to_segment=1, device="cpu", **kw)(pixels[None])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == np.uint16 and g.max() > 10
        np.testing.assert_array_equal(g, w)
