"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface, ``build/aliby_tpu_torch/<name>-<digest>.so`` at the
repository root, the digest covering the source and the flags. A library
is built at its first use, or all at once by :func:`build` (one nvcc
process per source, started together). Nothing is compiled at import.

Every C entry returns ``cudaGetLastError()`` after its launches; the
Python wrappers raise through :func:`check` when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
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
        "successor_prop_rounds": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
        "diffuse_mask": (_P, _P, _I, _I, _I, _P),
        "diffuse_step": (_P, _P, _P, _P, _I, _I, _I, _P),
    },
    "segsum": {
        "binned_sum_cols": (_P, _P, _P, _P, _I, _L, _I, _I, _L, _P),
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
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
