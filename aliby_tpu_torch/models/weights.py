"""Weights: a msgpack reader and writer for Flax checkpoints and the
converters between Flax parameter trees and PyTorch ``state_dict``s.

The reader covers what ``flax.serialization`` writes (maps, str, bin,
ints, floats, arrays, and ext type 1 = ndarray, whose payload is itself a
msgpack ``(shape, dtype name, buffer)``), the writer what a parameter tree
needs (maps of str keys, arrays), so checkpoints load and save without
``msgpack`` or ``flax``; the writer gives the bytes of
``flax.serialization.to_bytes`` (keys in each dict's own order).
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


class _Writer:
    """msgpack as ``msgpack.packb(..., use_bin_type=True)`` packs the types
    of a Flax parameter tree (dicts, str keys, numpy arrays as
    ``flax.serialization``'s ext type 1)."""

    def __init__(self):
        self.out = bytearray()

    def put(self, fmt: str, *values) -> None:
        self.out += struct.pack(fmt, *values)

    def _header(self, n: int, fix: int | None, fix_max: int, codes: tuple) -> None:
        """A length header: the fix form below ``fix_max``, else the 8-,
        16- or 32-bit form (``codes``; None where the type has none)."""
        if fix is not None and n < fix_max:
            self.put(">B", fix | n)
            return
        for code, fmt, limit in zip(codes, ("B", "H", "I"), (1 << 8, 1 << 16, 1 << 32)):
            if code is not None and n < limit:
                self.put(">B" + fmt, code, n)
                return
        raise ValueError(f"msgpack object too long ({n})")

    def write(self, obj) -> None:
        if isinstance(obj, int) and not isinstance(obj, bool) and 0 <= obj < 1 << 64:
            if obj < 0x80:
                self.put(">B", obj)
            elif obj < 1 << 32:  # the shortest unsigned form
                self._header(obj, None, 0, (0xCC, 0xCD, 0xCE))
            else:
                self.put(">BQ", 0xCF, obj)
        elif isinstance(obj, str):
            data = obj.encode("utf-8")
            self._header(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
            self.out += data
        elif isinstance(obj, bytes):
            self._header(len(obj), None, 0, (0xC4, 0xC5, 0xC6))
            self.out += obj
        elif isinstance(obj, dict):
            self._header(len(obj), 0x80, 16, (None, 0xDE, 0xDF))
            for k, v in obj.items():
                self.write(k)
                self.write(v)
        elif isinstance(obj, list):
            self._header(len(obj), 0x90, 16, (None, 0xDC, 0xDD))
            for v in obj:
                self.write(v)
        elif isinstance(obj, np.ndarray):
            self._ndarray(obj)
        else:
            raise TypeError(f"cannot msgpack {type(obj).__name__} in a parameter tree")

    def _ndarray(self, arr: np.ndarray) -> None:
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes cannot be serialised")
        payload = _Writer()
        payload.write([list(arr.shape), arr.dtype.name, arr.tobytes("C")])
        data = bytes(payload.out)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if len(data) in fixext:
            self.put(">B", fixext[len(data)])
        else:
            self._header(len(data), None, 0, (0xC7, 0xC8, 0xC9))
        self.put(">b", _EXT_NDARRAY)
        self.out += data


def msgpack_serialize(tree) -> bytes:
    """Nested dicts (str keys) of numpy arrays -> the bytes that
    ``flax.serialization.to_bytes`` gives for them: keys in each dict's own
    order, no leaf at flax's 2^30-byte chunking threshold."""
    writer = _Writer()
    writer.write(tree)
    return bytes(writer.out)


# the inverse of params_from_flax's names
_INNER_FLAX = {v: k for k, v in _INNER.items()}
_INNER_ORDER = ("GroupNorm_0", "Conv_0", "GroupNorm_1", "Conv_1", "proj")


def flax_from_params(state: dict[str, torch.Tensor]) -> dict:
    """A :class:`~.unet.CellposeNet` ``state_dict`` -> the Flax param tree
    ``{"params": {...}}`` of numpy arrays (the inverse of
    :func:`params_from_flax`): conv kernels OIHW -> HWIO, Linear (out, in)
    -> Dense (in, out), GroupNorm weight -> scale; the dtype kept. Modules
    and leaves come in the order Flax creates them (``stem``, ``down0a``,
    ``down0b``, ..., then for each decoder stage from the deepest
    ``up{i}_reduce``, ``style{i}``, ``up{i}a``, ``up{i}b``; ``head`` last;
    inside a block ``GroupNorm_0, Conv_0, GroupNorm_1, Conv_1, proj``)."""
    n_levels = 1 + max(int(k.split(".")[1]) for k in state if k.startswith("down."))
    decoder = 1 + 2 * n_levels  # rank of the first decoder module
    leaves = []
    for key, value in state.items():
        arr = value.detach().cpu().numpy()
        *mod, name = key.split(".")
        if mod[0] in ("down", "up"):
            i, j, inner = int(mod[1]), int(mod[2]), _INNER_FLAX[mod[3]]
            path = (f"{mod[0]}{i}{'ab'[j]}", inner)
            rank = (1 + 2 * i + j if mod[0] == "down"
                    else decoder + 4 * (n_levels - 2 - i) + 2 + j, _INNER_ORDER.index(inner))
            norm = inner.startswith("GroupNorm")
        elif mod[0] in ("up_reduce", "style"):
            i = int(mod[1])
            path = (f"up{i}_reduce",) if mod[0] == "up_reduce" else (f"style{i}",)
            rank = (decoder + 4 * (n_levels - 2 - i) + (mod[0] == "style"), 0)
            norm = False
        elif mod == ["stem"] or mod == ["head"]:
            path = (mod[0],)
            rank = (0 if mod[0] == "stem" else decoder + 4 * (n_levels - 1), 0)
            norm = False
        else:
            raise KeyError(f"unexpected parameter {key}")
        if name == "weight":
            leaf = "scale" if norm else "kernel"
            if not norm:
                arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        elif name == "bias":
            leaf = "bias"
        else:
            raise KeyError(f"unexpected parameter {key}")
        leaves.append((rank, leaf != "bias", path + (leaf,), np.ascontiguousarray(arr)))
    tree: dict = {}
    for _, _, path, arr in sorted(leaves, key=lambda t: (t[0], not t[1])):
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = arr
    return {"params": tree}
