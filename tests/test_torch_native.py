"""The port's native TIFF decoder (``aliby_tpu_torch.native``) against PIL and
the JAX package's decoder (``aliby_tpu.native``) on the same files: the
cases of ``tests/test_native.py`` (every compression, uint8, pages, batches,
the data plane's route), the files of ``chip_smoke.py``'s baseline-TIFF
writer (strips, deflate, big-endian), where the library is built, the
reference's contract when it cannot be built or loaded, the build without
``<zlib.h>``, and several builds at once.

The JAX package builds its library in place (``g++ -o
aliby_tpu/native/_aliby_host.so``, no temporary name) and loads any file at
that path not older than its source, once a process: under xdist several
workers link it at once, and one that loads a half-written file keeps
``None`` for the rest of its life. So this file (and
``test_torch_example01_tiff.py``) points the JAX loader at a library that
only this process builds (:func:`private_jax_native`)."""

import logging
import os
import threading
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from aliby_tpu import native as jax_native
from aliby_tpu_torch import native
from aliby_tpu_torch.io import image
from aliby_tpu_torch.test_data import get_dataset_path
from chip_smoke import write_tiff

ROOT = Path(__file__).resolve().parent.parent


@contextmanager
def private_jax_native(directory):
    """The JAX package's native loader pointed at ``directory``: its own
    ``_build()`` compiles its own source there, a file that no other process
    writes, and loads it. Asserts that it loaded, with the loader's warnings
    in the message; restores the loader's state on exit."""
    records = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = records.append
    log = logging.getLogger("aliby_tpu")
    Path(directory).mkdir(parents=True, exist_ok=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_LIB_PATH", Path(directory) / "_aliby_host.so")
        mp.setattr(jax_native, "_lib", None)
        mp.setattr(jax_native, "_tried", False)
        log.addHandler(handler)
        try:
            ok = jax_native.available()
        finally:
            log.removeHandler(handler)
        assert ok, "the JAX package's native library did not build or load: " + "; ".join(
            r.getMessage() for r in records)
        yield jax_native._LIB_PATH


@pytest.fixture(scope="module", autouse=True)
def built(tmp_path_factory):
    with private_jax_native(tmp_path_factory.mktemp("jax_native")):
        assert native.available(), "the port's native library did not build or load"
        yield


def decoded_alike(path, want, page: int = 0) -> None:
    """The port's decode of ``path`` equals ``want``, PIL's page and the JAX
    package's decode (same values, same dtype)."""
    ours = native.tiff_decode(path, page=page)
    assert ours is not None
    with Image.open(path) as im:
        im.seek(page)
        pil = np.asarray(im)
    assert ours.dtype == want.dtype and ours.shape == want.shape
    np.testing.assert_array_equal(ours, want)
    np.testing.assert_array_equal(ours, pil)
    ref = jax_native.tiff_decode(path, page=page)
    assert ref.dtype == ours.dtype
    np.testing.assert_array_equal(ours, ref)


def test_decode_fixture_matches_pil():
    path = sorted(get_dataset_path("crop_cellpainting_256").glob("*.tif"))[0]
    with Image.open(path) as im:
        decoded_alike(path, np.asarray(im))


@pytest.mark.parametrize("compression", [None, "tiff_lzw", "packbits", "tiff_adobe_deflate"])
def test_decode_compressions(tmp_path, compression):
    arr = np.random.default_rng(0).integers(0, 2**16, (37, 53), dtype=np.uint16)
    f = tmp_path / "x.tif"
    Image.fromarray(arr).save(f, compression=compression)
    decoded_alike(f, arr)


def test_decode_uint8(tmp_path):
    arr = np.arange(64, dtype=np.uint8).reshape(8, 8)
    f = tmp_path / "u8.tif"
    Image.fromarray(arr).save(f)
    decoded_alike(f, arr)


def test_multipage(tmp_path):
    pages = [np.full((5, 6), i, np.uint16) for i in range(4)]
    f = tmp_path / "mp.tif"
    Image.fromarray(pages[0]).save(
        f, save_all=True, append_images=[Image.fromarray(p) for p in pages[1:]])
    assert native.tiff_info(f) == jax_native.tiff_info(f) == (6, 5, 16, 4)
    for page in (0, 2, 3):
        decoded_alike(f, pages[page], page=page)
    assert native.tiff_decode(f, page=4) is None


def test_batch_decode(tmp_path):
    rng = np.random.default_rng(1)
    arrs = [rng.integers(0, 1000, (16, 16), dtype=np.uint16) for _ in range(6)]
    paths = []
    for i, a in enumerate(arrs):
        paths.append(tmp_path / f"b{i}.tif")
        Image.fromarray(a).save(paths[-1])
    before = native.decodes
    out = native.tiff_decode_batch(paths)
    assert out.shape == (6, 16, 16) and native.decodes == before + 6
    np.testing.assert_array_equal(out, np.stack(arrs))
    np.testing.assert_array_equal(out, jax_native.tiff_decode_batch(paths))
    pages = [np.full((4, 5), i, np.uint16) for i in range(3)]
    mp = tmp_path / "mp.tif"
    Image.fromarray(pages[0]).save(mp, save_all=True,
                                   append_images=[Image.fromarray(p) for p in pages[1:]])
    out = native.tiff_decode_batch([mp, mp, mp], pages=[2, 0, 1])
    np.testing.assert_array_equal(out, np.stack([pages[2], pages[0], pages[1]]))
    assert native.tiff_decode_batch([]) is None


def test_dataplane_uses_native():
    """The image layer routes .tif reads through the native decoder."""
    path = sorted(get_dataset_path("crop_cellpainting_256").glob("*.tif"))[0]
    before = native.decodes
    arr = image._read_image_file(path)
    assert native.decodes == before + 1
    with Image.open(path) as im:
        np.testing.assert_array_equal(arr, np.asarray(im))


@pytest.mark.parametrize("dtype", [np.uint16, np.uint8])
@pytest.mark.parametrize("deflate, big_endian, rows", [
    (False, False, 7), (True, False, 16), (False, True, 5), (True, True, 64)])
def test_chip_smoke_writer_decodes_as_pil_reads_it(tmp_path, dtype, deflate, big_endian, rows):
    arr = np.random.default_rng(2).integers(0, np.iinfo(dtype).max, (45, 31), dtype=dtype)
    f = tmp_path / "w.tif"
    write_tiff(f, arr, rows, deflate=deflate, big_endian=big_endian)
    assert f.read_bytes()[:2] == (b"MM" if big_endian else b"II")
    decoded_alike(f, arr)


def test_a_half_written_jax_library_stays_none_and_the_private_one_loads(tmp_path, monkeypatch):
    """The hazard that :func:`private_jax_native` avoids: a library at the
    JAX loader's path that the linker has not finished (here its ELF header
    and part of its program headers), newer than its source, is loaded as it
    is; the load fails and the process keeps ``None`` (``_tried`` is set
    first). (Cut past its program headers, ``dlopen`` maps segments beyond
    the file's end and the process dies of SIGBUS.) A private path built by
    this process loads."""
    whole = jax_native._LIB_PATH.read_bytes()
    assert whole[:4] == b"\x7fELF"
    half = tmp_path / "shared" / "_aliby_host.so"
    half.parent.mkdir()
    cut = 64 + 56  # the ELF header and one of its program headers
    half.write_bytes(whole[:cut])
    newer = jax_native._SRC.stat().st_mtime + 60
    os.utime(half, (newer, newer))
    monkeypatch.setattr(jax_native, "_LIB_PATH", half)
    monkeypatch.setattr(jax_native, "_lib", None)
    monkeypatch.setattr(jax_native, "_tried", False)
    assert jax_native._load() is None and jax_native._tried
    assert half.stat().st_size == cut  # loaded as it was, not rebuilt
    assert jax_native._load() is None  # and None for the rest of the process
    arr = np.arange(30, dtype=np.uint16).reshape(5, 6)
    f = tmp_path / "x.tif"
    Image.fromarray(arr).save(f)
    assert jax_native.tiff_decode(f) is None
    with private_jax_native(tmp_path / "private") as path:
        assert path.parent == tmp_path / "private" and path.exists()
        np.testing.assert_array_equal(jax_native.tiff_decode(f), arr)
    assert jax_native._LIB_PATH == half and jax_native._lib is None


def test_library_lands_under_build(tmp_path, monkeypatch):
    """The library is built from the port's own source into the build
    directory; no path of the build lies under ``aliby_tpu/`` or ``native/``."""
    import subprocess

    assert native.library_path().parent == ROOT / "build" / "aliby_tpu_torch"
    assert native.library_path().exists()
    assert native.SRC == ROOT / "aliby_tpu_torch" / "native" / "csrc" / "aliby_host.cpp"
    commands = []
    run = subprocess.run

    def spy(cmd, **kw):
        commands.append(cmd)
        return run(cmd, **kw)

    monkeypatch.setattr(native.subprocess, "run", spy)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "b")
    built = native.build()
    assert built.parent == tmp_path / "b" and built.name.startswith("aliby_host-")
    assert [p.name for p in (tmp_path / "b").iterdir()] == [built.name]
    compile_cmd = [c for c in commands if str(native.SRC) in c]
    assert len(compile_cmd) == 1
    for arg in compile_cmd[0]:
        for forbidden in (ROOT / "aliby_tpu", ROOT / "native"):
            assert not Path(arg).is_relative_to(forbidden), arg


def test_concurrent_builds(tmp_path, monkeypatch):
    """Builds at once into one directory: each gets the library, no
    temporary file stays."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    results, errors = [], []

    def one():
        try:
            results.append(native.build())
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=one) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(set(results)) == 1 and [p.name for p in tmp_path.iterdir()] == [results[0].name]


def test_unavailable_is_the_references_contract(tmp_path, monkeypatch, caplog):
    """A build that fails logs a warning; available() is False, the decode
    returns None and the image layer reads with imageio."""
    def fail():
        raise RuntimeError("no compiler")

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "build", fail)
    with caplog.at_level("WARNING", logger="aliby_tpu_torch"):
        assert not native.available()
    assert "no compiler" in caplog.text
    arr = np.arange(30, dtype=np.uint16).reshape(5, 6)
    f = tmp_path / "x.tif"
    Image.fromarray(arr).save(f)
    assert native.tiff_decode(f) is None and native.tiff_decode_batch([f]) is None
    np.testing.assert_array_equal(image._read_image_file(f), arr)


def test_build_without_zlib(tmp_path, monkeypatch):
    """Without <zlib.h> the deflate case is compiled out: such a TIFF is an
    unsupported compression (None, and imageio in the image layer), the
    others decode."""
    import ctypes

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "has_zlib", lambda: False)
    assert native.NO_ZLIB in native.compile_args()[0]
    assert "-lz" not in native.compile_args()[1]
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.available() and native.library_path().parent == tmp_path
    arr = np.arange(12 * 9, dtype=np.uint16).reshape(12, 9)
    for deflate in (False, True):
        f = tmp_path / f"d{int(deflate)}.tif"
        write_tiff(f, arr, 4, deflate=deflate)
        got = native.tiff_decode(f)
        if deflate:
            u32 = ctypes.c_uint32
            out = np.empty_like(arr)
            assert got is None and native._lib.aliby_tiff_decode(
                str(f).encode(), 0, out.ctypes.data_as(ctypes.c_void_p), out.nbytes,
                u32(), u32(), u32()) == -10
            np.testing.assert_array_equal(image._read_image_file(f), arr)
        else:
            np.testing.assert_array_equal(got, arr)
