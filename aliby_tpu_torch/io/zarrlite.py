"""Minimal self-contained Zarr directory-store reader/writer (counterpart of
``aliby_tpu/io/zarrlite.py``).

The zarr-python package is not a dependency; this module implements just
enough of the v2 (``.zarray``/``.zgroup``, e.g. zarr DirectoryStore) and v3
(``zarr.json``, LocalStore) on-disk formats to cover the reference's zarr
input modalities (``aliby/io/image.py:236-276``): C-order chunked arrays with
null / zlib / gzip / zstd / lz4 / blosc compressors. zlib, gzip, raw and
blosc's own framing need numpy and the stdlib only; zstd and lz4 blocks go
through pyarrow's codecs, imported where they are decoded (the GPU hosts of
the port need not have pyarrow). JPEG-XL chunks are decoded and written
through the system libjxl (``io/jxl.py``), or decoded by ``imagecodecs``
where libjxl is absent.

Chunks are decoded on demand — ``ZarrArray`` is an indexable (shape/dtype/
``__getitem__``) suitable for the lazy-view layer.
"""

from __future__ import annotations

import json
import zlib
from functools import lru_cache
from pathlib import Path

import numpy as np

def _codec(name: str):
    """pyarrow's ``name`` codec, imported at the first block that needs it."""
    try:
        import pyarrow as pa
    except ImportError as e:
        raise RuntimeError(f"{name} zarr blocks need pyarrow") from e
    return pa.Codec(name)

_BLOSC_CODECS = {0: "blosclz", 1: "lz4", 2: "snappy", 3: "zlib", 4: "zstd"}


def _decompress_blosc(buf: bytes, out_nbytes: int, typesize_hint: int) -> bytes:
    """Decode a blosc1 frame: 16-byte header, block starts, per-block streams."""
    version, _versionlz, flags, typesize = buf[0], buf[1], buf[2], buf[3]
    nbytes = int.from_bytes(buf[4:8], "little")
    blocksize = int.from_bytes(buf[8:12], "little")
    cbytes = int.from_bytes(buf[12:16], "little")
    del version, cbytes
    codec = _BLOSC_CODECS.get((flags >> 5) & 0x7, "unknown")
    memcpyed = bool(flags & 0x2)
    if memcpyed:
        raw = buf[16 : 16 + nbytes]
    else:
        nblocks = -(-nbytes // blocksize)
        starts = [
            int.from_bytes(buf[16 + 4 * i : 20 + 4 * i], "little")
            for i in range(nblocks)
        ]
        out = bytearray()
        for i, start in enumerate(starts):
            this_block = min(blocksize, nbytes - i * blocksize)
            csize = int.from_bytes(buf[start : start + 4], "little")
            payload = buf[start + 4 : start + 4 + csize]
            if csize == this_block:  # stored uncompressed
                out += payload
            elif codec == "zlib":
                out += zlib.decompress(payload)
            elif codec == "zstd":
                out += _codec("zstd").decompress(
                    payload, decompressed_size=this_block
                ).to_pybytes()
            elif codec == "lz4":
                out += _codec("lz4_raw").decompress(
                    payload, decompressed_size=this_block
                ).to_pybytes()
            else:
                raise NotImplementedError(f"blosc inner codec {codec!r}")
        raw = bytes(out[:nbytes])
    if flags & 0x1 and typesize > 1:  # byte shuffle
        arr = np.frombuffer(raw, dtype=np.uint8).reshape(typesize, -1)
        raw = arr.T.tobytes()
    elif flags & 0x4:  # bit shuffle
        bits = np.unpackbits(np.frombuffer(raw, dtype=np.uint8))
        n_elem = len(raw) // typesize
        bits = bits.reshape(typesize * 8, n_elem)
        raw = np.packbits(bits.T.reshape(-1)).tobytes()
    del typesize_hint
    return raw


def _decompress(buf: bytes, compressor: dict | None, out_nbytes: int, typesize: int) -> bytes:
    if compressor is None:
        return buf
    cid = compressor.get("id", compressor.get("name"))
    if cid in ("zlib", "gzip"):
        try:
            return zlib.decompress(buf)
        except zlib.error:
            import gzip as _gz

            return _gz.decompress(buf)
    if cid == "zstd":
        return _codec("zstd").decompress(buf, decompressed_size=out_nbytes).to_pybytes()
    if cid == "blosc":
        return _decompress_blosc(buf, out_nbytes, typesize)
    if cid == "lz4":
        return _codec("lz4_raw").decompress(
            buf, decompressed_size=out_nbytes
        ).to_pybytes()
    if cid in ("jpegxl", "imagecodecs_jpegxl", "jxl"):
        # libjxl through io/jxl.py first; imagecodecs only if libjxl is absent
        from aliby_tpu_torch.io import jxl as _jxl

        if _jxl.available():
            return np.ascontiguousarray(_jxl.decode(buf)).tobytes()
        try:
            import imagecodecs
        except ImportError as e:
            raise RuntimeError(
                "This zarr store uses JPEG-XL-compressed chunks "
                f"(compressor id {cid!r}); decoding requires the system "
                "libjxl shared library (or the 'imagecodecs' package), "
                "neither of which is available."
            ) from e
        return np.ascontiguousarray(imagecodecs.jpegxl_decode(buf)).tobytes()
    raise NotImplementedError(f"zarr compressor {cid!r}")


class ZarrArray:
    """Read-only chunked array over a v2/v3 zarr directory node."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        meta2 = self.path / ".zarray"
        meta3 = self.path / "zarr.json"
        if meta2.exists():
            meta = json.loads(meta2.read_text())
            self.zarr_format = 2
            self.shape = tuple(meta["shape"])
            self.chunks = tuple(meta["chunks"])
            self.dtype = np.dtype(meta["dtype"])
            self._compressor = meta.get("compressor")
            self._sep = meta.get("dimension_separator", ".")
            self._prefix = ""
            if meta.get("order", "C") != "C":
                raise NotImplementedError("F-order zarr arrays")
            if meta.get("filters"):
                raise NotImplementedError("zarr v2 filters")
            self._fill = meta.get("fill_value", 0)
        elif meta3.exists():
            meta = json.loads(meta3.read_text())
            if meta.get("node_type") != "array":
                raise ValueError(f"{path} is a zarr group, not an array")
            self.zarr_format = 3
            self.shape = tuple(meta["shape"])
            self.chunks = tuple(meta["chunk_grid"]["configuration"]["chunk_shape"])
            self.dtype = np.dtype(meta["data_type"])
            codecs = meta.get("codecs", [])
            self._compressor = None
            for c in codecs:
                name = c.get("name")
                if name in ("gzip", "zstd", "blosc", "lz4", "jpegxl",
                            "imagecodecs_jpegxl", "jxl"):
                    self._compressor = {"id": name, **c.get("configuration", {})}
                elif name in ("bytes", "endian"):
                    endian = c.get("configuration", {}).get("endian", "little")
                    if endian == "big":
                        self.dtype = self.dtype.newbyteorder(">")
                else:
                    raise NotImplementedError(f"zarr v3 codec {name!r}")
            cke = meta.get("chunk_key_encoding", {"name": "default"})
            if cke.get("name") == "v2":
                self._sep = cke.get("configuration", {}).get("separator", ".")
                self._prefix = ""
            else:
                self._sep = cke.get("configuration", {}).get("separator", "/")
                self._prefix = "c"
            self._fill = meta.get("fill_value", 0)
        else:
            raise FileNotFoundError(f"no .zarray or zarr.json under {path}")
        self.ndim = len(self.shape)
        self._grid = tuple(
            -(-s // c) for s, c in zip(self.shape, self.chunks)
        )
        self._read_chunk = lru_cache(maxsize=16)(self._read_chunk_impl)

    def _chunk_file(self, coords: tuple[int, ...]) -> Path:
        parts = [str(c) for c in coords]
        if self._prefix:
            name = "/".join([self._prefix] + parts) if self._sep == "/" else (
                self._prefix + self._sep + self._sep.join(parts)
            )
        else:
            name = self._sep.join(parts) if self._sep == "." else "/".join(parts)
        return self.path / name

    def _read_chunk_impl(self, coords: tuple[int, ...]) -> np.ndarray:
        f = self._chunk_file(coords)
        nbytes = int(np.prod(self.chunks)) * self.dtype.itemsize
        if not f.exists():
            return np.full(self.chunks, self._fill, dtype=self.dtype)
        raw = _decompress(f.read_bytes(), self._compressor, nbytes, self.dtype.itemsize)
        return np.frombuffer(raw, dtype=self.dtype).reshape(self.chunks).copy()

    def __getitem__(self, idx) -> np.ndarray:
        from aliby_tpu_torch.io.lazy import _normalize_index

        idx = _normalize_index(idx, self.ndim)
        ranges = []
        is_int = []
        for ax, i in enumerate(idx):
            if isinstance(i, int):
                i = i if i >= 0 else i + self.shape[ax]
                if not 0 <= i < self.shape[ax]:
                    raise IndexError(
                        f"index {i} out of range for axis {ax} (size {self.shape[ax]})"
                    )
                ranges.append(range(i, i + 1))
                is_int.append(True)
            else:
                ranges.append(range(*i.indices(self.shape[ax])))
                is_int.append(False)
        out_shape = tuple(len(r) for r in ranges)
        out = np.empty(out_shape, dtype=self.dtype)
        # Gather by chunk: iterate over the chunk boxes intersecting the request.
        lo = [r.start for r in ranges]
        hi = [r.stop if len(r) else r.start for r in ranges]
        c_lo = [a // c for a, c in zip(lo, self.chunks)]
        c_hi = [max((b - 1) // c, a // c) for a, b, c in zip(lo, hi, self.chunks)]
        for chunk_coords in np.ndindex(*[h - l + 1 for l, h in zip(c_lo, c_hi)]):
            coords = tuple(l + o for l, o in zip(c_lo, chunk_coords))
            chunk = self._read_chunk(coords)
            src_sel, dst_sel = [], []
            for ax in range(self.ndim):
                c0 = coords[ax] * self.chunks[ax]
                a = max(lo[ax], c0)
                b = min(hi[ax], c0 + self.chunks[ax], self.shape[ax])
                if b <= a:
                    src_sel = None
                    break
                src_sel.append(slice(a - c0, b - c0))
                dst_sel.append(slice(a - lo[ax], b - lo[ax]))
            if src_sel is None:
                continue
            out[tuple(dst_sel)] = chunk[tuple(src_sel)]
        for ax in sorted((a for a, f in enumerate(is_int) if f), reverse=True):
            out = np.squeeze(out, ax)
        return out


def open_group(path: str | Path) -> dict:
    """Return {key: relative path} of array nodes directly under a zarr group."""
    path = Path(path)
    arrays = {}
    for child in sorted(path.iterdir()):
        if child.is_dir() and (
            (child / ".zarray").exists() or (child / "zarr.json").exists()
        ):
            arrays[child.name] = child
    return arrays


def read_attrs(path: str | Path) -> dict:
    path = Path(path)
    for name in (".zattrs", "zarr.json"):
        f = path / name
        if f.exists():
            meta = json.loads(f.read_text())
            return meta.get("attributes", meta) if name == "zarr.json" else meta
    return {}


def is_zarr_node(path: str | Path) -> bool:
    p = Path(path)
    return any((p / n).exists() for n in (".zarray", ".zgroup", "zarr.json", ".zattrs"))


def write_array(
    path: str | Path,
    arr: np.ndarray,
    chunks: tuple[int, ...] | None = None,
    attrs: dict | None = None,
    compressor: str | None = "zlib",
) -> None:
    """Write a v2 directory-store array (zlib, jpegxl or raw): fixtures and
    outputs. ``jpegxl`` requires image-shaped chunks (all leading chunk dims
    1, trailing (Y, X) = the image plane) and encodes each chunk losslessly
    through the libjxl binding (``io/jxl.py``)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    if chunks is None:
        chunks = (1,) * max(0, arr.ndim - 2) + arr.shape[max(0, arr.ndim - 2):]
    if compressor == "jpegxl":
        if any(c != 1 for c in chunks[:-2]) or len(chunks) < 2:
            raise ValueError(
                "jpegxl compression needs (1, ..., 1, Y, X) image chunks; "
                f"got {chunks}"
            )
        comp_meta = {"id": "jpegxl"}
    else:
        comp_meta = {"id": "zlib", "level": 1} if compressor == "zlib" else None
    meta = {
        "zarr_format": 2,
        "shape": list(arr.shape),
        "chunks": list(chunks),
        "dtype": arr.dtype.str,
        "compressor": comp_meta,
        "fill_value": 0,
        "order": "C",
        "filters": None,
    }
    (path / ".zarray").write_text(json.dumps(meta))
    if attrs:
        (path / ".zattrs").write_text(json.dumps(attrs))
    grid = [-(-s // c) for s, c in zip(arr.shape, chunks)]
    for coords in np.ndindex(*grid):
        sel = tuple(
            slice(c * ch, min((c + 1) * ch, s))
            for c, ch, s in zip(coords, chunks, arr.shape)
        )
        block = np.zeros(chunks, dtype=arr.dtype)
        view = arr[sel]
        block[tuple(slice(0, v) for v in view.shape)] = view
        if comp_meta and comp_meta["id"] == "jpegxl":
            from aliby_tpu_torch.io import jxl as _jxl

            payload = _jxl.encode(block.reshape(block.shape[-2:]))
        else:
            payload = block.tobytes()
            if comp_meta:
                payload = zlib.compress(payload, 1)
        (path / ".".join(map(str, coords))).write_bytes(payload)


def write_group(path: str | Path, arrays: dict[str, np.ndarray], attrs: dict | None = None) -> None:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    (path / ".zgroup").write_text(json.dumps({"zarr_format": 2}))
    if attrs:
        (path / ".zattrs").write_text(json.dumps(attrs))
    for key, arr in arrays.items():
        write_array(path / key, arr)
