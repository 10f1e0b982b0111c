"""ctypes bindings for the port's native host runtime (counterpart of
``aliby_tpu/native``): a baseline TIFF decoder (raw, LZW, PackBits and
deflate strips; 8/16-bit; multi-page) and a threaded batch decode, in
``native/csrc/aliby_host.cpp``, the port's own copy of the source.

The library is built with g++ at its first use, or by :func:`build`, into
``build/aliby_tpu_torch/aliby_host-<digest>.so`` at the repository root,
the digest covering the source and the flags. It is written under a
temporary name and renamed into place, so several processes may build it at
once. Nothing is compiled or loaded at import. Where the host has no
``<zlib.h>`` (probed once), the deflate case is compiled out and such a
TIFF decodes as one of an unsupported compression: ``None``.

:func:`available` is the data plane's test, as the reference's: a build or
load that fails logs a warning and returns False, and the image layer then
reads TIFFs with imageio. :func:`build` raises with the compiler's output.
``decodes`` counts the pages decoded natively.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from aliby_tpu_torch.kernels._build import BUILD_DIR

logger = logging.getLogger("aliby_tpu_torch")

SRC = Path(__file__).resolve().parent / "csrc" / "aliby_host.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
NO_ZLIB = "-DALIBY_NO_ZLIB"

_lock = threading.Lock()
_lib = None
_tried = False
decodes = 0


@functools.cache
def has_zlib() -> bool:
    """Whether g++ finds ``<zlib.h>`` on this host."""
    try:
        proc = subprocess.run(["g++", "-x", "c++", "-fsyntax-only", "-"],
                              input="#include <zlib.h>\n", capture_output=True, text=True,
                              timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return False
    return proc.returncode == 0


def compile_args() -> tuple[tuple[str, ...], tuple[str, ...]]:
    """(flags before the source, libraries after it): the reference's
    ``g++ -O3 -shared -fPIC -std=c++17 ... -lz -pthread``, or without zlib."""
    if has_zlib():
        return CXX_FLAGS, ("-lz", "-pthread")
    return CXX_FLAGS + (NO_ZLIB,), ("-pthread",)


def library_path() -> Path:
    flags, libs = compile_args()
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(flags + libs).encode())
    return BUILD_DIR / f"aliby_host-{digest.hexdigest()[:12]}.so"


def build() -> Path:
    """Compile the library unless it is built; raises ``RuntimeError`` with
    g++'s output when the compiler is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags, libs = compile_args()
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *flags, str(SRC), "-o", str(tmp), *libs]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"aliby_host build failed: {' '.join(cmd)}: {e}") from e
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"aliby_host build failed (g++ exit {proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
        except (RuntimeError, OSError) as e:
            logger.warning("native build or load failed: %s", e)
            return None
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.aliby_tiff_info.argtypes = [ctypes.c_char_p, u32p, u32p, u32p, u32p]
        lib.aliby_tiff_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_uint64, u32p, u32p, u32p,
        ]
        lib.aliby_tiff_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int), ctypes.c_int,
            ctypes.c_void_p, ctypes.c_uint64, u32p, u32p, u32p,
        ]
        for fn in (lib.aliby_tiff_info, lib.aliby_tiff_decode, lib.aliby_tiff_decode_batch):
            fn.restype = ctypes.c_int
        _lib = lib
        return _lib


def _count(n: int) -> None:
    global decodes
    with _lock:
        decodes += n


def available() -> bool:
    return _load() is not None


def tiff_info(path: str | Path):
    """(width, height, bits, pages) or None."""
    lib = _load()
    if lib is None:
        return None
    w, h, b, p = (ctypes.c_uint32() for _ in range(4))
    if lib.aliby_tiff_info(str(path).encode(), w, h, b, p) != 0:
        return None
    return w.value, h.value, b.value, p.value


def tiff_decode(path: str | Path, page: int = 0) -> np.ndarray | None:
    """One page as an (H, W) uint8/uint16 array, or None where the decoder
    cannot read it."""
    lib = _load()
    if lib is None:
        return None
    info = tiff_info(path)
    if info is None:
        return None
    width, height, bits, _pages = info
    out = np.empty((height, width), np.uint16 if bits == 16 else np.uint8)
    w, h, b = (ctypes.c_uint32() for _ in range(3))
    rc = lib.aliby_tiff_decode(str(path).encode(), page, out.ctypes.data_as(ctypes.c_void_p),
                               out.nbytes, w, h, b)
    if rc != 0:
        return None
    _count(1)
    return out


def tiff_decode_batch(paths, pages=None) -> np.ndarray | None:
    """Decode N same-shaped TIFF pages in parallel -> (N, H, W), or None."""
    lib = _load()
    if lib is None or not paths:
        return None
    info = tiff_info(paths[0])
    if info is None:
        return None
    width, height, bits, _ = info
    n = len(paths)
    out = np.empty((n, height, width), np.uint16 if bits == 16 else np.uint8)
    c_paths = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    c_pages = (ctypes.c_int * n)(*(pages or [0] * n))
    w, h, b = (ctypes.c_uint32() for _ in range(3))
    rc = lib.aliby_tiff_decode_batch(c_paths, c_pages, n, out.ctypes.data_as(ctypes.c_void_p),
                                     out.nbytes // n, w, h, b)
    if rc != 0:
        return None
    _count(n)
    return out
