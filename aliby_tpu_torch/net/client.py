"""Remote model-server clients, the nahual-equivalent surface (counterpart
of ``aliby_tpu/net/client.py``).

Each closure opens one :class:`~aliby_tpu_torch.net.wire.Client`, sets up a
session on the server's model group and sends each call's data over the
wire (:mod:`aliby_tpu_torch.net.wire`); the model runs where the server
runs. The server may be this package's
:class:`~aliby_tpu_torch.net.server.ModelServer` or the JAX package's: the
frames are the same bytes.
"""

from __future__ import annotations

import numpy as np

from aliby_tpu_torch.net.wire import Client


def make_remote_segmenter(kind: str, channel_to_segment: int = 0, **kwargs):
    """Client closure for ``nahual_cellpose`` / ``nahual_baby`` /
    ``nahual_spotiflow`` (any ``nahual_<group>``): (F, C, Z, Y, X) pixels
    -> the server's masks as uint16 (with BABY's metadata when it sends
    some)."""
    address = kwargs.get("address") or (kwargs.get("segmenter_kwargs") or {}).get("address")
    if address is None:
        raise ValueError(f"{kind} requires an 'address' parameter")
    model_group = kind.removeprefix("nahual_")
    client = Client(address)
    session = client.call("setup", model=model_group, params=kwargs.get("setup_params", {}))

    def segment(pixels, **_ignored):
        pixels = np.asarray(pixels)
        if pixels.ndim == 6:
            pixels = pixels[0]
        sel = pixels[:, channel_to_segment]
        sel = sel.max(axis=1) if sel.shape[1] > 1 else sel[:, 0]
        result = client.call("process", session=session, model=model_group, data=sel)
        masks = result["masks"] if isinstance(result, dict) else result
        out = [np.asarray(m).astype(np.uint16) for m in masks]
        if isinstance(result, dict) and "metadata" in result:
            return {"masks": out, "metadata": result["metadata"]}
        return out

    return segment


def make_remote_embedder(address: str | None = None, model_group: str = "embed",
                         channels=None, **kwargs):
    """Client closure for ``nahual_embed``: (F, C, Z, Y, X) crops -> the
    server's (F, dim) embeddings."""
    if address is None:
        raise ValueError("nahual_embed requires an 'address' parameter")
    client = Client(address)
    session = client.call("setup", model=model_group, params=kwargs.get("setup_params", {}))

    def embed(pixels, **_ignored) -> np.ndarray:
        pixels = np.asarray(pixels, np.float32)
        if channels is not None:
            pixels = pixels[:, channels]
        return np.asarray(client.call("process", session=session, model=model_group,
                                      data=pixels))

    return embed


def make_remote_global_step(model_group: str, address: str | None = None, parameters=None,
                            **kwargs):
    """Client closure for a ``nahual_<group>`` global step (``trackastra``):
    the whole-movie stack -> the server's columns as numpy arrays (a
    caller that wants a table makes one with ``pyarrow.Table.from_pydict``)."""
    if address is None:
        raise ValueError(f"nahual_{model_group} requires an 'address' parameter")
    client = Client(address)
    session = client.call("setup", model=model_group, params=parameters or {})

    def process(stacked, **_ignored):
        stacked = np.asarray(stacked)
        if stacked.ndim == 5:  # strip get_step_output's fetcher axis
            stacked = stacked[0]
        result = client.call("process", session=session, model=model_group, data=stacked)
        if not isinstance(result, dict):
            return result
        return {k: np.asarray(v) for k, v in result.items()}

    return process
