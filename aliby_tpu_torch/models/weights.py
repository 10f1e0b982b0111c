"""Weights: a msgpack reader for Flax checkpoints and the Flax -> PyTorch
parameter converter.

The reader covers what ``flax.serialization`` writes (maps, str, bin,
ints, floats, arrays, and ext type 1 = ndarray, whose payload is itself a
msgpack ``(shape, dtype name, buffer)``), so the bundled checkpoint loads
without ``msgpack`` or ``flax``.
"""

from __future__ import annotations

import re
import struct
from pathlib import Path

import numpy as np
import torch

# The bundled checkpoint of the JAX package, read by path (a data file).
BUNDLED_WEIGHTS = (
    Path(__file__).resolve().parents[2]
    / "aliby_tpu" / "models" / "weights" / "cellpose_synthetic.msgpack"
)

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self.unpack(fixed[b])
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I",  # bin
                 0xD9: ">B", 0xDA: ">H", 0xDB: ">I",  # str
                 0xDC: ">H", 0xDD: ">I",              # array
                 0xDE: ">H", 0xDF: ">I",              # map
                 0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}  # ext
        if b in sized:
            n = self.unpack(sized[b])
            if b in (0xC4, 0xC5, 0xC6):
                return bytes(self.take(n))
            if b in (0xD9, 0xDA, 0xDB):
                return self._str(n)
            if b in (0xDC, 0xDD):
                return self._array(n)
            if b in (0xDE, 0xDF):
                return self._map(n)
            return self._ext(n)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(fixext[b])
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def _str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, n: int):
        code = self.unpack(">b")
        payload = bytes(self.take(n))
        if code not in (_EXT_NDARRAY, _EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        shape, dtype, buf = _Reader(payload).read()
        if isinstance(dtype, bytes):
            dtype = dtype.decode()
        arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()
        return arr if code == _EXT_NDARRAY else arr[()]


def msgpack_restore(data: bytes):
    """Decode Flax msgpack bytes into nested dicts of numpy arrays."""
    reader = _Reader(data)
    out = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after msgpack object")
    return out


def read_flax_checkpoint(path: str | Path) -> dict:
    return msgpack_restore(Path(path).read_bytes())


_BLOCK = re.compile(r"^(down|up)(\d+)([ab])$")
_INNER = {"Conv_0": "conv0", "Conv_1": "conv1", "GroupNorm_0": "norm0",
          "GroupNorm_1": "norm1", "proj": "proj"}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """A Flax ``CellposeNet`` param tree (with or without the top-level
    ``params`` key) -> a ``state_dict`` for :class:`~.unet.CellposeNet`.

    Conv kernels HWIO -> OIHW, Dense (in, out) -> (out, in), GroupNorm
    scale -> weight; every leaf becomes f32 (the checkpoint stores f16)."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    state = {}
    for path, leaf in _flatten(tree):
        arr = np.array(leaf, dtype=np.float32)  # a writable copy
        top, *inner, name = path
        m = _BLOCK.match(top)
        if m:
            kind, i, ab = m.groups()
            if len(inner) != 1 or inner[0] not in _INNER:
                raise KeyError(f"unexpected parameter {'/'.join(path)}")
            mod = f"{kind}.{i}.{'01'[ab == 'b']}.{_INNER[inner[0]]}"
        elif top.startswith("up") and top.endswith("_reduce"):
            mod = f"up_reduce.{top[2:-len('_reduce')]}"
        elif top.startswith("style"):
            mod = f"style.{top[len('style'):]}"
        elif top in ("stem", "head"):
            mod = top
        else:
            raise KeyError(f"unexpected parameter {'/'.join(path)}")
        if name == "kernel":
            arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            key = "weight"
        elif name == "scale":
            key = "weight"
        elif name == "bias":
            key = "bias"
        else:
            raise KeyError(f"unexpected parameter {'/'.join(path)}")
        state[f"{mod}.{key}"] = torch.from_numpy(np.ascontiguousarray(arr))
    return state
