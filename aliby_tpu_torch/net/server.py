"""Model server: hosts the port's models behind the wire protocol
(counterpart of ``aliby_tpu/net/server.py``).

The off-host counterpart of the reference's nahual servers (cellpose,
BABY, spotiflow, trackastra, the embedder zoo): CPU clients run positions
and send frames to one server that owns the card. Each model group maps
onto the port's own implementation on the server's ``device`` (``cuda``
unless the caller passes ``device="cpu"``):

- ``cellpose``: :func:`~aliby_tpu_torch.models.segment._make_cellpose_segmenter`
  (the flagship U-Net, or the CPnet graph of a torch checkpoint);
- ``threshold``: the threshold segmenter;
- ``baby``: the BABY-class segmenter; its session keeps the tracking state;
- ``spotiflow``: :func:`~aliby_tpu_torch.models.spots.make_spot_segmenter`;
- ``embed``: :func:`~aliby_tpu_torch.models.embedder.make_embedder`;
- ``trackastra``: the whole-movie linker
  (:func:`~aliby_tpu_torch.track.linker.link_tracks_columns`).

Protocol (the JAX package's): ``setup`` returns a session id, ``process``
runs the session's model on ``data``, ``describe`` returns the session's
model group and ``impl`` (the qualified name of the function that serves
it), ``ping`` returns ``"pong"``; an error is sent back as ``{"error":
"<type>: <message>"}``. One thread serves each connection.
"""

from __future__ import annotations

import socket
import threading
import uuid
from pathlib import Path

import numpy as np

from aliby_tpu_torch.device import resolve_device
from aliby_tpu_torch.net.wire import cleanup_ipc, parse_address, recv_msg, send_msg

SEGMENTER_GROUPS = ("cellpose", "threshold", "baby", "spotiflow")


class ModelServer:
    def __init__(self, address: str, device=None):
        self.address = address
        self.device = resolve_device(device)
        self._sessions: dict[str, dict] = {}
        self._sock: socket.socket | None = None
        self._thread: threading.Thread | None = None
        self._running = False

    # -- model dispatch -----------------------------------------------------

    def _setup(self, model: str, params: dict) -> str:
        params = dict(params or {})
        device = self.device
        if model == "cellpose":
            from aliby_tpu_torch.models.segment import _make_cellpose_segmenter

            fn = _make_cellpose_segmenter(channel_to_segment=0, device=device, **params)
        elif model == "threshold":
            from aliby_tpu_torch.models.segment import _make_threshold_segmenter

            fn = _make_threshold_segmenter(channel_to_segment=0, device=device, **params)
        elif model == "baby":
            from aliby_tpu_torch.models.baby import make_baby_segmenter

            fn = make_baby_segmenter(channel_to_segment=0, device=device, **params)
        elif model == "spotiflow":
            from aliby_tpu_torch.models.spots import make_spot_segmenter

            fn = make_spot_segmenter(channel_to_segment=0, device=device, **params)
        elif model == "embed":
            from aliby_tpu_torch.models.embedder import make_embedder

            fn = make_embedder(device=device, **params)
        elif model == "trackastra":
            from aliby_tpu_torch.track.linker import link_tracks_columns

            def fn(stacked, **_):
                # wire contract: (T, F, Y, X) or mono (T, Y, X)
                return link_tracks_columns(np.asarray(stacked), device=device)
        else:
            raise ValueError(f"unknown model group {model!r}")
        session_id = str(uuid.uuid4())
        self._sessions[session_id] = {
            "model": model,
            "fn": fn,
            "impl": f"{fn.__module__}.{getattr(fn, '__qualname__', fn.__name__)}",
        }
        return session_id

    def _process(self, session: str, data: np.ndarray):
        entry = self._sessions.get(session)
        if entry is None:
            raise KeyError(f"unknown session {session!r}")
        fn = entry["fn"]
        data = np.asarray(data)
        if entry["model"] in SEGMENTER_GROUPS:
            # clients send (F, Y, X); segmenters take (F, C, Z, Y, X)
            out = fn(data[:, None, None])
            if isinstance(out, dict):  # BABY: layered masks + tracking/lineage metadata
                return {"masks": [np.asarray(m) for m in out["masks"]],
                        "metadata": out.get("metadata")}
            return {"masks": [np.asarray(m) for m in out]}
        if entry["model"] == "embed":
            return fn(data)
        # trackastra: the reference's reply carries the columns as lists
        return {c: v.tolist() for c, v in fn(data).items()}

    # -- socket plumbing ----------------------------------------------------

    def _handle_conn(self, conn: socket.socket) -> None:
        with conn:
            while self._running:
                try:
                    msg = recv_msg(conn)
                except (ConnectionError, OSError):
                    return
                if msg is None:
                    return
                try:
                    op = msg.pop("op")
                    if op == "setup":
                        result = self._setup(msg["model"], msg.get("params") or {})
                    elif op == "process":
                        result = self._process(msg["session"], msg["data"])
                    elif op == "describe":
                        entry = self._sessions[msg["session"]]
                        result = {"model": entry["model"], "impl": entry["impl"]}
                    elif op == "ping":
                        result = "pong"
                    else:
                        raise ValueError(f"unknown op {op!r}")
                    send_msg(conn, {"result": result})
                except Exception as e:  # surface errors to the client
                    try:
                        send_msg(conn, {"error": f"{type(e).__name__}: {e}"})
                    except OSError:
                        return

    def start(self) -> "ModelServer":
        kind, target = parse_address(self.address)
        if kind == "unix":
            cleanup_ipc(self.address)
            Path(target).parent.mkdir(parents=True, exist_ok=True)
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        else:
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind(target)
        sock.listen(16)
        sock.settimeout(0.5)
        self._sock = sock
        self._running = True

        def loop():
            while self._running:
                try:
                    conn, _ = sock.accept()
                except socket.timeout:
                    continue
                except OSError:
                    return
                threading.Thread(target=self._handle_conn, args=(conn,), daemon=True).start()

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._running = False
        if self._sock is not None:
            self._sock.close()
        if self._thread is not None:
            self._thread.join(timeout=2)
        cleanup_ipc(self.address)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
