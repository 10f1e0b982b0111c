"""The port's JPEG-XL codec (``aliby_tpu_torch.io.jxl``) and the zarr layer's
JPEG-XL chunks against the JAX package's: the cases of
``tests/test_zarrlite.py`` (``TestJxlFirstParty``, the imagecodecs fallback
and the error without either decoder), the ``cellpainting_zarr_jxl``
fixture's chunk files byte for byte, and the JXL plate equal to the zlib
plate (``tests/test_dataset.py::test_jxl_plate_matches_zlib_plate``).
Without the system libjxl the codec's tests skip, as the JAX package's do."""

import json
import sys
import types

import numpy as np
import pytest

from aliby_tpu.io import jxl as jax_jxl
from aliby_tpu.io import zarrlite as jax_zarrlite
from aliby_tpu.test_data import get_dataset_path as jax_dataset_path
from aliby_tpu_torch.io import jxl, zarrlite
from aliby_tpu_torch.io.image import ImageZarr
from aliby_tpu_torch.test_data import get_dataset_path


def _v2_node(tmp_path, name, arr, compressor, payload):
    node = tmp_path / name
    node.mkdir()
    meta = {"zarr_format": 2, "shape": list(arr.shape), "chunks": list(arr.shape),
            "dtype": arr.dtype.str, "compressor": compressor, "fill_value": 0, "order": "C",
            "filters": None}
    (node / ".zarray").write_text(json.dumps(meta))
    (node / ("0" + ".0" * (arr.ndim - 1))).write_bytes(payload)
    return node


def test_jpegxl_no_decoder_names_codec(tmp_path, monkeypatch):
    """JXL chunks with neither libjxl nor imagecodecs raise the reference's
    RuntimeError."""
    arr = np.zeros((4, 4), np.uint16)
    node = _v2_node(tmp_path, "jxl", arr, {"id": "imagecodecs_jpegxl"}, b"\xff\x0a fake")
    monkeypatch.setattr(jxl, "available", lambda: False)
    monkeypatch.setattr(jax_jxl, "available", lambda: False)
    monkeypatch.setitem(sys.modules, "imagecodecs", None)  # `import imagecodecs` raises
    for z in (zarrlite.ZarrArray(node), jax_zarrlite.ZarrArray(node)):
        with pytest.raises(RuntimeError, match="JPEG-XL.*libjxl.*imagecodecs"):
            z[:]


def test_jpegxl_decodes_via_imagecodecs_fallback(tmp_path, monkeypatch):
    """Without libjxl, JXL chunks go through imagecodecs if importable."""
    arr = np.arange(16, dtype=np.uint16).reshape(4, 4)
    node = _v2_node(tmp_path, "jxl_ok", arr, {"id": "jpegxl"}, b"JXLPAYLOAD")
    monkeypatch.setattr(jxl, "available", lambda: False)
    fake = types.ModuleType("imagecodecs")
    fake.jpegxl_decode = lambda buf: arr if buf == b"JXLPAYLOAD" else None
    monkeypatch.setitem(sys.modules, "imagecodecs", fake)
    np.testing.assert_array_equal(zarrlite.ZarrArray(node)[:], arr)


def test_v3_jxl_codec_names(tmp_path, monkeypatch):
    """The v3 codec names the reference accepts select the JXL decoder."""
    arr = np.arange(6, dtype=np.uint16).reshape(2, 3)
    fake = types.ModuleType("imagecodecs")
    fake.jpegxl_decode = lambda buf: arr
    monkeypatch.setattr(jxl, "available", lambda: False)
    monkeypatch.setitem(sys.modules, "imagecodecs", fake)
    for name in ("jpegxl", "imagecodecs_jpegxl", "jxl"):
        node = tmp_path / name
        (node / "c" / "0").mkdir(parents=True)
        (node / "zarr.json").write_text(json.dumps({
            "zarr_format": 3, "node_type": "array", "shape": [2, 3], "data_type": "uint16",
            "chunk_grid": {"name": "regular", "configuration": {"chunk_shape": [2, 3]}},
            "codecs": [{"name": "bytes", "configuration": {"endian": "little"}},
                       {"name": name}], "fill_value": 0}))
        (node / "c" / "0" / "0").write_bytes(b"x")
        np.testing.assert_array_equal(zarrlite.ZarrArray(node)[:], arr)


@pytest.fixture()
def libjxl():
    if not jxl.available():
        pytest.skip("system libjxl not present")


def test_encode_decode_roundtrip_dtypes(libjxl):
    rng = np.random.default_rng(7)
    for arr in (
        rng.integers(0, 2**16, (40, 56), dtype=np.uint16),
        rng.integers(0, 255, (31, 17), dtype=np.uint8),
        rng.random((24, 24)).astype(np.float32),
        rng.integers(0, 255, (20, 30, 3), dtype=np.uint8),
        rng.integers(0, 2**16, (12, 10, 3), dtype=np.uint16),
    ):
        buf = jxl.encode(arr)
        assert buf == jax_jxl.encode(arr)
        for out in (jxl.decode(buf), jax_jxl.decode(buf)):
            assert out.dtype == arr.dtype and out.shape == arr.shape
            np.testing.assert_array_equal(out, arr)


def test_truncated_stream_raises(libjxl):
    buf = jxl.encode(np.zeros((8, 8), np.uint16))
    with pytest.raises((ValueError, RuntimeError)):
        jxl.decode(buf[: len(buf) // 2])
    with pytest.raises(ValueError, match="bad shape"):
        jxl.encode(np.zeros((2, 2, 5), np.uint8))
    with pytest.raises(ValueError, match="unsupported dtype"):
        jxl.encode(np.zeros((2, 2), np.int32))


def test_zarr_store_with_jxl_chunks(tmp_path, libjxl):
    """A jpegxl v2 store round-trips bit-exactly, and its files are the JAX
    package's bytes."""
    arr = np.random.default_rng(3).integers(0, 2**16, (2, 3, 24, 33), dtype=np.uint16)
    zarrlite.write_array(tmp_path / "a", arr, chunks=(1, 1, 24, 33), compressor="jpegxl")
    jax_zarrlite.write_array(tmp_path / "b", arr, chunks=(1, 1, 24, 33), compressor="jpegxl")
    names = sorted(p.name for p in (tmp_path / "b").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "a").iterdir())
    for name in names:
        assert (tmp_path / "a" / name).read_bytes() == (tmp_path / "b" / name).read_bytes()
    z = zarrlite.ZarrArray(tmp_path / "a")
    np.testing.assert_array_equal(z[:], arr)
    np.testing.assert_array_equal(z[1, 2], arr[1, 2])
    with pytest.raises(ValueError, match="image chunks"):
        zarrlite.write_array(tmp_path / "c", arr, chunks=(2, 1, 24, 33), compressor="jpegxl")


def test_image_zarr_over_jxl_plate(tmp_path, libjxl):
    arr = np.random.default_rng(5).integers(0, 2**16, (2, 2, 1, 16, 16), dtype=np.uint16)
    zarrlite.write_array(tmp_path / "pos0", arr, chunks=(1, 1, 1, 16, 16), compressor="jpegxl")
    img = ImageZarr(tmp_path / "pos0")
    np.testing.assert_array_equal(np.asarray(img.data[1, 0, 0]), arr[1, 0, 0])


def test_jxl_fixture_is_the_jax_packages_bytes(libjxl):
    ours, theirs = get_dataset_path("cellpainting_zarr_jxl"), jax_dataset_path(
        "cellpainting_zarr_jxl")
    files = sorted(p.relative_to(theirs) for p in theirs.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(ours) for p in ours.rglob("*") if p.is_file())
    for f in files:
        assert (ours / f).read_bytes() == (theirs / f).read_bytes(), f


def test_jxl_plate_matches_zlib_plate(libjxl):
    for well in ("A01", "B02"):
        a = zarrlite.ZarrArray(get_dataset_path("cellpainting_zarr") / well)
        b = zarrlite.ZarrArray(get_dataset_path("cellpainting_zarr_jxl") / well)
        np.testing.assert_array_equal(a[:], b[:])
        np.testing.assert_array_equal(b[:], jax_zarrlite.ZarrArray(
            jax_dataset_path("cellpainting_zarr_jxl") / well)[:])
