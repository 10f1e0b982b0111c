"""The port's ``external_data`` against the JAX package's, with no network:
the same catalogue; the fetcher over ``file://`` URLs (the hash checked, the
file renamed into place, nothing left behind on a mismatch) and against a
closed port on this host (``OfflineError``, no ``.part`` file); and
``get_image_data_root`` / ``get_swainlab_log`` over a cache that already
holds the pinned files (each pin pointed at a local file's hash), which
give the JAX package's trees."""

import hashlib
import io
import tarfile
from pathlib import Path

import pytest

from aliby_tpu import external_data as J
from aliby_tpu_torch import external_data as X


def test_catalogue_is_the_jax_packages():
    assert X.IMAGE_TARBALL == J.IMAGE_TARBALL
    assert X.IMAGE_DATASETS == J.IMAGE_DATASETS
    assert X.SWAINLAB_LOGS == J.SWAINLAB_LOGS
    assert list(X.SWAINLAB_LOGS) == list(J.SWAINLAB_LOGS)


def test_cache_root(tmp_path, monkeypatch):
    monkeypatch.delenv("ALIBY_TPU_TORCH_EXTERNAL_CACHE", raising=False)
    assert X.cache_root().parts[-3:] == (".cache", "aliby_tpu_torch", "external")
    monkeypatch.setenv("ALIBY_TPU_TORCH_EXTERNAL_CACHE", str(tmp_path))
    assert X.cache_root() == tmp_path


@pytest.mark.parametrize("algo", ["sha256", "md5"])
def test_fetch_a_file_url_checks_its_hash(tmp_path, algo):
    data = bytes(range(256)) * 4099  # past one read of 1 MiB
    src = tmp_path / "src.bin"
    src.write_bytes(data)
    digest = hashlib.new(algo, data).hexdigest()
    dest = tmp_path / "cache" / "x.bin"
    assert X._fetch(src.as_uri(), dest, **{algo: digest}) == dest
    assert dest.read_bytes() == data and not dest.with_suffix(".bin.part").exists()
    src.unlink()  # a cached file of the right hash is not fetched again
    assert X._fetch(src.as_uri(), dest, **{algo: digest}) == dest

    src.write_bytes(data)
    other = tmp_path / "cache" / "y.bin"
    with pytest.raises(RuntimeError, match="hash mismatch") as e:
        X._fetch(src.as_uri(), other, **{algo: "0" * len(digest)})
    assert not isinstance(e.value, X.OfflineError)
    assert not other.exists() and not other.with_suffix(".bin.part").exists()


def test_fetch_offline_error(tmp_path):
    """A closed port on this host: OfflineError, no file, no partial file."""
    dest = tmp_path / "x.bin"
    with pytest.raises(X.OfflineError):
        X._fetch("http://127.0.0.1:1/nope", dest, sha256="0" * 64, timeout=2.0)
    assert not dest.exists() and not dest.with_suffix(".bin.part").exists()
    assert list(tmp_path.iterdir()) == []


def _tarball(under: str | None) -> bytes:
    """A tarball with a file in each of the catalogue's sub-datasets, at
    its top level or under ``under``."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tf:
        for i, entry in enumerate(J.IMAGE_DATASETS):
            data = f"{entry['name']} {i}\n".encode()
            name = f"{entry['name']}/pos{i}/img_{i:03d}.tif"
            info = tarfile.TarInfo(f"{under}/{name}" if under else name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    return buf.getvalue()


def _tree(root) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() if p.is_file() else None
            for p in sorted(root.rglob("*"))}


@pytest.mark.parametrize("under", [None, "aliby_tests"], ids=["top_level", "extract_dir"])
def test_image_data_root_unpacks_as_the_jax_package(tmp_path, monkeypatch, under):
    blob = _tarball(under)
    digest = hashlib.sha256(blob).hexdigest()
    roots = {}
    for mod, env in ((J, "ALIBY_TPU_EXTERNAL_CACHE"), (X, "ALIBY_TPU_TORCH_EXTERNAL_CACHE")):
        cache = tmp_path / mod.__name__
        cache.mkdir()
        (cache / mod.IMAGE_TARBALL["fname"]).write_bytes(blob)
        monkeypatch.setenv(env, str(cache))
        monkeypatch.setitem(mod.IMAGE_TARBALL, "sha256", digest)
        monkeypatch.setitem(mod.IMAGE_TARBALL, "url", "http://127.0.0.1:1/unused")
        root = mod.get_image_data_root(timeout=2.0)
        assert root == cache / "aliby_tests"
        roots[mod.__name__] = _tree(cache)
    got, want = roots["aliby_tpu_torch.external_data"], roots["aliby_tpu.external_data"]
    assert got == want
    assert sum(k.startswith("aliby_tests/") and v is not None for k, v in got.items()) == 5
    # unpacked once: a second call returns the tree as it is
    assert X.get_image_data_root(timeout=2.0) == tmp_path / X.__name__ / "aliby_tests"


def test_swainlab_log_from_the_cache(tmp_path, monkeypatch):
    name = next(iter(J.SWAINLAB_LOGS))
    text = b"Microscope log\n"
    paths = {}
    for mod, env in ((J, "ALIBY_TPU_EXTERNAL_CACHE"), (X, "ALIBY_TPU_TORCH_EXTERNAL_CACHE")):
        cache = tmp_path / mod.__name__
        (cache / "swainlab_logs").mkdir(parents=True)
        (cache / "swainlab_logs" / f"{name}.log").write_bytes(text)
        monkeypatch.setenv(env, str(cache))
        monkeypatch.setitem(mod.SWAINLAB_LOGS, name, {
            "md5": hashlib.md5(text).hexdigest(), "url": "http://127.0.0.1:1/unused"})
        paths[mod] = mod.get_swainlab_log(name, timeout=2.0).relative_to(cache)
    assert paths[X] == paths[J] == Path("swainlab_logs") / f"{name}.log"
    with pytest.raises(KeyError):
        X.get_swainlab_log("no such log")
