"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface, ``build/aliby_tpu_torch/<name>-<digest>.so`` at the
repository root, the digest covering the source and the flags. A library
is built at its first use, or all at once by :func:`build` (one nvcc
process per source, started together). Nothing is compiled at import.

Every C entry returns ``cudaGetLastError()`` after its launches; the
Python wrappers raise through :func:`check` when it is not 0.

The C entries launch on the CUDA runtime's current device of the calling
thread, with the stream they are given. A wrapper therefore makes the
tensor's device current around its launch (:func:`on_device`): a thread
working on ``cuda:1`` whose current device is 0 would otherwise launch on
device 0 with device-1 pointers. Wrappers count their launches through
:func:`count`, which several threads may call at once; :func:`tally`
counts one thread's launches apart (a shard of the mesh runner).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from contextlib import contextmanager, nullcontext
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "aliby_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
# argtypes of every C entry, by source
PROTOTYPES = {
    "stencil": {
        "successor_prop": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
        "diffuse_heat": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    },
    "segsum": {
        "binned_sum_cols": (_P, _P, _P, _P, _P, _P, _I, _L, _I, _L, _P),
        "segment_sum": (_P, _P, _P, _P, _P, _P, _L, _I, _L, _P),
        "binned_minmax": (_P, _P, _P, _P, _P, _P, _I, _L, _I, _I, _L, _P),
        "table_lookup": (_P, _P, _P, _I, _L, _I, _I, _I, _P),
    },
    "holes": {
        "fill_label_holes": (_P, _P, _P, _P, _I, _I, _I, _P),
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}  # nvcc/ptxas output of each build, by source


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")
    return nvcc


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def build(names=tuple(PROTOTYPES)) -> dict[str, Path]:
    """Compile every named source that is not built yet, all at once."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    pending = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        pending[name] = (proc, tmp, out)
    failed = []
    for name, (proc, tmp, out) in pending.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build((name,))[name]))
        for fn, argtypes in PROTOTYPES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_of(t: torch.Tensor) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``t``'s device
    (PyTorch's own raw-stream query: ``torch.cuda.current_stream`` builds a
    Stream object, several microseconds of host time a launch)."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def on_device(t: torch.Tensor):
    """A context that makes ``t``'s card the calling thread's current
    device for a launch (nothing to do when it already is)."""
    index = t.get_device()
    return nullcontext() if torch.cuda.current_device() == index else torch.cuda.device(index)


_COUNT_LOCK = threading.Lock()
_TALLY = threading.local()


def count(wrapper, n: int = 1) -> None:
    """Add ``n`` launches to ``wrapper.launches`` (under a lock: a
    read-modify-write from several threads would lose counts) and to the
    calling thread's :func:`tally`, if one is open."""
    with _COUNT_LOCK:
        wrapper.launches += n
    tallied = getattr(_TALLY, "counts", None)
    if tallied is not None:
        tallied[wrapper.__name__] = tallied.get(wrapper.__name__, 0) + n


@contextmanager
def tally():
    """Count the launches that this thread makes inside the block, by
    wrapper name: ``with tally() as counts: ...``."""
    outer = getattr(_TALLY, "counts", None)
    counts: dict[str, int] = {}
    _TALLY.counts = counts
    try:
        yield counts
    finally:
        _TALLY.counts = outer
        if outer is not None:
            for name, n in counts.items():
                outer[name] = outer.get(name, 0) + n
