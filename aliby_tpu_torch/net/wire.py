"""Length-prefixed numpy-aware REQ/REP wire protocol (counterpart of
``aliby_tpu/net/wire.py``, stdlib and numpy only).

It speaks the reference's address conventions (``ipc:///path.ipc`` unix
sockets, ``tcp://host:port``). Frame layout: ``u64 length | u32 header_len
| header json | raw buffers``. The JSON header describes the value tree;
ndarrays are replaced by ``{"__nd__": i, "dtype": ..., "shape": ...}``
placeholders whose bytes are appended in order, and raw ``bytes`` by sized
``{"__bytes__": i, "n": ...}`` ones; no pickle on the wire. A frame is the
same bytes as the JAX package's for the same value, so clients and servers
of either package talk to each other.
"""

from __future__ import annotations

import json
import socket
import struct
from pathlib import Path

import numpy as np


def _encode(value) -> bytes:
    buffers: list[bytes] = []

    def walk(v):
        if isinstance(v, np.ndarray):
            idx = len(buffers)
            arr = np.ascontiguousarray(v)
            buffers.append(arr.tobytes())
            return {"__nd__": idx, "dtype": arr.dtype.str, "shape": list(arr.shape)}
        if isinstance(v, (np.integer,)):
            return int(v)
        if isinstance(v, (np.floating,)):
            return float(v)
        if isinstance(v, bytes):
            idx = len(buffers)
            buffers.append(v)
            return {"__bytes__": idx, "n": len(v)}
        if isinstance(v, dict):
            return {"__dict__": [[walk(k), walk(val)] for k, val in v.items()]}
        if isinstance(v, (list, tuple)):
            return {"__list__": [walk(x) for x in v], "__tuple__": isinstance(v, tuple)}
        if v is None or isinstance(v, (bool, int, float, str)):
            return {"__val__": v}
        raise TypeError(f"unsupported wire type {type(v)}")

    header = json.dumps(walk(value)).encode()
    body = b"".join(buffers)
    return struct.pack("<QI", 4 + len(header) + len(body) + 8, len(header)) + header + body


def _decode(frame: bytes):
    (header_len,) = struct.unpack_from("<I", frame, 0)
    header = json.loads(frame[4 : 4 + header_len].decode())
    body = frame[4 + header_len :]
    offsets = [0]

    # First pass: compute buffer offsets by walking in encode order.
    sizes: list[int] = []

    def sizes_walk(node):
        if isinstance(node, dict):
            if "__nd__" in node:
                n = int(np.prod(node["shape"])) * np.dtype(node["dtype"]).itemsize
                sizes.append(n)
            elif "__bytes__" in node:
                # sized in the header since r2; -1 marks a legacy unsized
                # blob (at most one per message, length inferred)
                sizes.append(node.get("n", -1))
            elif "__dict__" in node:
                for k, v in node["__dict__"]:
                    sizes_walk(k)
                    sizes_walk(v)
            elif "__list__" in node:
                for x in node["__list__"]:
                    sizes_walk(x)

    sizes_walk(header)
    if sizes.count(-1) > 1:
        raise ValueError(
            "at most one legacy (unsized) raw-bytes blob per message; "
            "current senders size every blob in the header"
        )
    known = sum(s for s in sizes if s >= 0)
    for s in sizes:
        offsets.append(offsets[-1] + (s if s >= 0 else len(body) - known))

    counter = {"i": 0}

    def build(node):
        if isinstance(node, dict):
            if "__nd__" in node:
                i = counter["i"]
                counter["i"] += 1
                start, stop = offsets[i], offsets[i + 1]
                return np.frombuffer(
                    body[start:stop], dtype=np.dtype(node["dtype"])
                ).reshape(node["shape"]).copy()
            if "__bytes__" in node:
                i = counter["i"]
                counter["i"] += 1
                return body[offsets[i] : offsets[i + 1]]
            if "__dict__" in node:
                return {build(k): build(v) for k, v in node["__dict__"]}
            if "__list__" in node:
                items = [build(x) for x in node["__list__"]]
                return tuple(items) if node.get("__tuple__") else items
            if "__val__" in node:
                return node["__val__"]
        raise ValueError(f"bad wire node {node!r}")

    return build(header)


def parse_address(address: str):
    if address.startswith("ipc://"):
        return ("unix", address.removeprefix("ipc://"))
    if address.startswith("tcp://"):
        host, port = address.removeprefix("tcp://").rsplit(":", 1)
        return ("tcp", (host, int(port)))
    raise ValueError(f"unsupported address {address!r} (use ipc:// or tcp://)")


def _open_socket(address: str) -> socket.socket:
    kind, target = parse_address(address)
    if kind == "unix":
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    else:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    s.connect(target)
    return s


def send_msg(sock: socket.socket, value) -> None:
    frame = _encode(value)
    sock.sendall(frame)


def recv_msg(sock: socket.socket):
    head = _recv_exact(sock, 8)
    if head is None:
        return None
    (total,) = struct.unpack("<Q", head)
    rest = _recv_exact(sock, total - 8)
    if rest is None:
        raise ConnectionError("peer closed mid-frame")
    return _decode(rest)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, 1 << 20))
        if not chunk:
            return None if got == 0 else None
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


class Client:
    """One-socket-per-client REQ/REP with reconnect-per-call simplicity."""

    def __init__(self, address: str, timeout: float = 120.0):
        self.address = address
        self.timeout = timeout
        self._sock: socket.socket | None = None

    def _ensure(self) -> socket.socket:
        if self._sock is None:
            self._sock = _open_socket(self.address)
            self._sock.settimeout(self.timeout)
        return self._sock

    def call(self, op: str, **payload):
        sock = self._ensure()
        try:
            send_msg(sock, {"op": op, **payload})
            reply = recv_msg(sock)
        except (ConnectionError, OSError):
            self.close()
            sock = self._ensure()
            send_msg(sock, {"op": op, **payload})
            reply = recv_msg(sock)
        if isinstance(reply, dict) and reply.get("error"):
            raise RuntimeError(f"server error: {reply['error']}")
        if isinstance(reply, dict) and "result" in reply:
            return reply["result"]
        return reply

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None


def cleanup_ipc(address: str) -> None:
    kind, target = parse_address(address)
    if kind == "unix":
        Path(target).unlink(missing_ok=True)
