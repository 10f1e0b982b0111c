"""Global (post-run, whole-movie) step dispatch (counterpart of
``aliby_tpu/engine/global_steps.py``): global steps consume the full per-tp
stack that ``engine.core.get_step_output`` fetches and return the tracks
as numpy columns (``engine.core.finalize_position`` makes the table it
writes). ``track_global`` is the in-process linker on ``device``;
``nahual_<group>`` is a client of a model server's group at ``address``."""

from __future__ import annotations

import numpy as np


def dispatch_global_step(name: str, device=None, **params):
    if name.startswith("nahual_"):
        from aliby_tpu_torch.net.client import make_remote_global_step

        return make_remote_global_step(name.removeprefix("nahual_"),
                                       address=params.get("address"),
                                       parameters=params.get("parameters"))
    if name.startswith("track_global") or name == "trackastra":
        from aliby_tpu_torch.track.linker import link_tracks_columns

        def process(stacked, **_):
            # get_step_output emits (n_fetchers, T, F, Y, X); callable fetchers
            # may give (T, F, Y, X) or (T, Y, X)
            stacked = np.asarray(stacked)
            if stacked.ndim == 5:
                stacked = stacked[0]
            return link_tracks_columns(stacked, device=device,
                                       **(params.get("parameters") or {}))

        return process
    raise ValueError(f"Unknown global step {name!r}")
