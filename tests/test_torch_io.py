"""The port's data plane (``aliby_tpu_torch.io``) against the JAX package's,
on the scenarios of ``tests/test_zarrlite.py`` and ``tests/test_dataset.py``:
zarr round trips (raw, zlib, ragged chunks, groups, v3 gzip, blosc memcpy
frames, lz4), ``LazyView`` indexing through ``adjust_dimensions``,
``ImageZarr``/``ImageList``/``ImageDir`` frames, ``DatasetDir``/``DatasetZarr``
discovery and the per-tp ``.npz`` saves: equal arrays, equal position lists,
equal files. JPEG-XL chunks decode (``tests/test_torch_jxl.py`` holds the
codec), or raise the reference's error where the host has no libjxl.
"""

import gzip
import json

import numpy as np
import pytest
from PIL import Image

from aliby_tpu.io import dataset as jax_dataset
from aliby_tpu.io import image as jax_image
from aliby_tpu.io import write as jax_write
from aliby_tpu.io import zarrlite as jax_zarrlite
from aliby_tpu.test_data import get_dataset, get_dataset_path
from aliby_tpu_torch.io import dataset, image, lazy, write, zarrlite


@pytest.mark.parametrize("compressor", [None, "zlib"])
def test_roundtrip_matches_the_reference(tmp_path, compressor):
    arr = np.random.default_rng(1).integers(0, 2**16, (4, 3, 32, 33), dtype=np.uint16)
    zarrlite.write_array(tmp_path / "a", arr, chunks=(1, 1, 32, 33), compressor=compressor)
    jax_zarrlite.write_array(tmp_path / "b", arr, chunks=(1, 1, 32, 33), compressor=compressor)
    for name in [".zarray"] + [p.name for p in (tmp_path / "b").iterdir()]:
        assert (tmp_path / "a" / name).read_bytes() == (tmp_path / "b" / name).read_bytes()
    z, jz = zarrlite.ZarrArray(tmp_path / "a"), jax_zarrlite.ZarrArray(tmp_path / "a")
    for idx in (slice(None), (2, 1), (slice(1, 3), slice(None), slice(4, 20), 5), (-1, 0, 3)):
        np.testing.assert_array_equal(z[idx], jz[idx])
    np.testing.assert_array_equal(z[:], arr)
    with pytest.raises(IndexError):
        z[4]


def test_ragged_chunks_and_groups(tmp_path):
    arr = np.arange(7 * 11, dtype=np.float32).reshape(7, 11)
    zarrlite.write_array(tmp_path / "a", arr, chunks=(3, 4))
    np.testing.assert_array_equal(zarrlite.ZarrArray(tmp_path / "a")[:], arr)
    np.testing.assert_array_equal(jax_zarrlite.ZarrArray(tmp_path / "a")[:], arr)
    zarrlite.write_group(tmp_path / "g", {"p1": np.ones((2, 2)), "p2": np.zeros((3, 3))},
                         attrs={"plate": 1})
    arrays = zarrlite.open_group(tmp_path / "g")
    assert {k: str(v) for k, v in arrays.items()} == {
        k: str(v) for k, v in jax_zarrlite.open_group(tmp_path / "g").items()}
    assert zarrlite.read_attrs(tmp_path / "g") == jax_zarrlite.read_attrs(tmp_path / "g")
    assert zarrlite.is_zarr_node(tmp_path / "g") and not zarrlite.is_zarr_node(tmp_path)


def _v2_node(tmp_path, name, arr, compressor, payload):
    node = tmp_path / name
    node.mkdir()
    meta = {"zarr_format": 2, "shape": list(arr.shape), "chunks": list(arr.shape),
            "dtype": arr.dtype.str, "compressor": compressor, "fill_value": 0, "order": "C",
            "filters": None}
    (node / ".zarray").write_text(json.dumps(meta))
    (node / ("0" + ".0" * (arr.ndim - 1))).write_bytes(payload)
    return node


def test_codecs(tmp_path):
    """v3 with gzip, a blosc memcpy frame, lz4 (pyarrow, imported where the
    block is decoded); jpegxl decodes and is written, or raises the
    reference's RuntimeError without libjxl (and imagecodecs)."""
    import pyarrow as pa

    arr = np.arange(24, dtype="<i4").reshape(4, 6)
    node = tmp_path / "v3"
    node.mkdir()
    (node / "zarr.json").write_text(json.dumps({
        "zarr_format": 3, "node_type": "array", "shape": [4, 6], "data_type": "int32",
        "chunk_grid": {"name": "regular", "configuration": {"chunk_shape": [2, 3]}},
        "chunk_key_encoding": {"name": "default", "configuration": {"separator": "/"}},
        "codecs": [{"name": "bytes", "configuration": {"endian": "little"}},
                   {"name": "gzip", "configuration": {"level": 1}}],
        "fill_value": 0}))
    for ci in range(2):
        for cj in range(2):
            (node / "c" / str(ci)).mkdir(parents=True, exist_ok=True)
            chunk = arr[ci * 2:ci * 2 + 2, cj * 3:cj * 3 + 3]
            (node / "c" / str(ci) / str(cj)).write_bytes(gzip.compress(chunk.tobytes()))
    small = np.arange(12, dtype="<u2").reshape(3, 4)
    payload = small.tobytes()
    header = bytes([2, 2, 0x2, 2]) + len(payload).to_bytes(4, "little") * 2 + \
        (len(payload) + 16).to_bytes(4, "little")
    blosc = _v2_node(tmp_path, "blosc", small, {"id": "blosc", "cname": "zstd"}, header + payload)
    lz4 = pa.Codec("lz4_raw").compress(arr.tobytes())
    lz4 = _v2_node(tmp_path, "lz4", arr, {"id": "lz4"},
                   lz4 if isinstance(lz4, bytes) else lz4.to_pybytes())
    for path, want in ((node, arr), (blosc, small), (lz4, arr)):
        np.testing.assert_array_equal(zarrlite.ZarrArray(path)[:], want)
        np.testing.assert_array_equal(jax_zarrlite.ZarrArray(path)[:], want)
    from aliby_tpu_torch.io import jxl as jxl_codec

    if jxl_codec.available():
        jxl = _v2_node(tmp_path, "jxl", small, {"id": "jpegxl"}, jxl_codec.encode(small))
        np.testing.assert_array_equal(zarrlite.ZarrArray(jxl)[:], small)
        np.testing.assert_array_equal(jax_zarrlite.ZarrArray(jxl)[:], small)
        zarrlite.write_array(tmp_path / "w", small, compressor="jpegxl")
        np.testing.assert_array_equal(zarrlite.ZarrArray(tmp_path / "w")[:], small)
    else:
        jxl = _v2_node(tmp_path, "jxl", small, {"id": "jpegxl"}, b"\xff\x0a")
        for z in (zarrlite.ZarrArray(jxl), jax_zarrlite.ZarrArray(jxl)):
            with pytest.raises(RuntimeError, match="JPEG-XL.*libjxl"):
                z[:]


def test_lazy_views_and_adjust_dimensions():
    src = np.arange(2 * 3 * 1 * 5 * 7).reshape(2, 3, 1, 5, 7)
    view = lazy.LazyView(src, list(range(5)))
    for order, a in (("TCZYX", src), ("CZYX", src[0]), ("ZTCYX", np.moveaxis(src, 2, 0)),
                     ("CYX", src[1, :, 0])):
        lv = lazy.LazyView(a, list(range(a.ndim)))
        got = image.adjust_dimensions(lv, order)
        want = jax_image.adjust_dimensions(lv, order)
        assert got.shape == want.shape
        for idx in ((0,), (slice(None), 1), (-1, slice(0, 2), 0, slice(1, 4)), Ellipsis):
            np.testing.assert_array_equal(got[idx], want[idx])
    sq = lazy.lazy_squeeze(view, 2)
    np.testing.assert_array_equal(sq[1, 2], src[1, 2, 0])
    np.testing.assert_array_equal(lazy.lazy_moveaxis(sq, [3, 0, 1, 2])[4, 1], src[1, :, 0, :, 4])
    np.testing.assert_array_equal(lazy.lazy_expand_last(sq)[0, 0, 0, 0], src[0, 0, 0, 0, :1])


def test_image_zarr_and_dataset_zarr():
    root = get_dataset_path("yeast_zarr")
    ds, jds = dataset.DatasetZarr(root), jax_dataset.DatasetZarr(root)
    positions = ds.get_position_ids()
    assert positions == jds.get_position_ids()
    assert [p["key"] for p in positions] == ["pos1", "pos2"]
    assert isinstance(dataset.dispatch_dataset(root), dataset.DatasetZarr)
    src = {"key": positions[0]["key"], "path": positions[0]["path"]}
    assert image.dispatch_image(src) is image.ImageZarr
    img = image.ImageZarr(src, capture_order="TCZYX")
    jimg = jax_image.ImageZarr(src, capture_order="TCZYX")
    assert img.data.shape == jimg.data.shape and img.name == jimg.name
    np.testing.assert_array_equal(img.data[1, 2], jimg.data[1, 2])
    np.testing.assert_array_equal(img.data[0, :, 1, 10:50, 3], jimg.data[0, :, 1, 10:50, 3])


def test_dataset_dir_and_image_list():
    entry = get_dataset("crop_cellpainting_256")
    root = get_dataset_path(entry["name"])
    kw = dict(regex=entry["regex"], capture_order=entry["capture_order"])
    positions = dataset.DatasetDir(root, **kw).get_position_ids()
    assert positions == jax_dataset.DatasetDir(root, **kw).get_position_ids()
    assert [p["key"] for p in positions] == ["A01__1"] and len(positions[0]["path"]) == 5
    assert isinstance(dataset.dispatch_dataset(root, **kw), dataset.DatasetDir)
    src = positions[0]["path"]
    assert image.dispatch_image(src) is image.ImageList
    img = image.ImageList(src, regex=entry["regex"], capture_order=entry["capture_order"])
    jimg = jax_image.ImageList(src, regex=entry["regex"], capture_order=entry["capture_order"])
    assert img.data.shape == jimg.data.shape and img.image_id == jimg.image_id
    np.testing.assert_array_equal(img.data[0, 3, 0], jimg.data[0, 3, 0])
    assert img.meta == jimg.meta


def test_yeast_tiff_positions_and_string_sort(tmp_path):
    entry = get_dataset("yeast_tiff")
    root = get_dataset_path(entry["name"])
    kw = dict(regex=entry["regex"], capture_order=entry["capture_order"])
    positions = dataset.DatasetDir(root, **kw).get_position_ids()
    assert positions == jax_dataset.DatasetDir(root, **kw).get_position_ids()
    assert [p["key"] for p in positions] == ["1", "2"]
    for t in [1, 2, 10]:
        (tmp_path / f"x__1__T{t}.tif").write_bytes(b"\x00")
    kw = dict(regex=r".*__([0-9])__T([0-9]+)\.tif", capture_order="FT")
    got = dataset.DatasetDir(tmp_path, **kw).get_position_ids()
    assert got == jax_dataset.DatasetDir(tmp_path, **kw).get_position_ids()
    assert [p.split("T")[-1].split(".")[0] for p in got[0]["path"]] == ["1", "10", "2"]


def test_image_dir_tcz_grid(tmp_path):
    frames = np.random.default_rng(0).integers(0, 1000, (2, 3, 2, 24, 24)).astype(np.uint16)
    for t in range(2):
        for c in range(3):
            for z in range(2):
                Image.fromarray(frames[t, c, z]).save(
                    tmp_path / f"img_t{t:03d}_c{c:02d}_z{z:02d}.tiff")
    assert image.dispatch_image(tmp_path) is image.ImageDir
    data = image.ImageDir(tmp_path).get_data_lazy()
    assert data.shape == (2, 3, 2, 24, 24)
    np.testing.assert_array_equal(np.asarray(data[1, 2, 0]), frames[1, 2, 0])
    np.testing.assert_array_equal(data[:, 1], jax_image.ImageDir(tmp_path).get_data_lazy()[:, 1])


def test_npz_saves_match_the_reference(tmp_path):
    rng = np.random.default_rng(2)
    masks = [rng.integers(0, 9, (16, 16)).astype(np.uint16) for _ in range(2)]
    tracked = {"labels": [m.astype(np.int32) for m in masks], "max_label": [8, 5]}
    tile = {"drift": {"drift": np.zeros(2)}, "pixels": np.ones((1, 2, 1, 4, 4))}
    assert write.dispatch_write_fn("segment_cell") is write.write_ndarray
    assert write.dispatch_write_fn("track_cell") is write.write_ndarray
    for name, result in (("segment_cell", masks), ("track_cell", tracked), ("tile", tile)):
        a = write.write_ndarray(result, steps_dir=tmp_path / "port", subpath=name, tp=3)
        b = jax_write.write_ndarray(result, steps_dir=tmp_path / "jax", subpath=name, tp=3)
        assert a.name == b.name == "0003.npz"
        with np.load(a, allow_pickle=True) as x, np.load(b, allow_pickle=True) as y:
            assert sorted(x.keys()) == sorted(y.keys())
            for k in x.keys():
                np.testing.assert_array_equal(x[k], y[k])
                assert x[k].dtype == y[k].dtype
