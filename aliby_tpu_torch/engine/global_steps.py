"""Global (post-run, whole-movie) step dispatch (counterpart of
``aliby_tpu/engine/global_steps.py``): global steps consume the full per-tp
stack that ``engine.core.get_step_output`` fetches and return a table. The
``track_global`` step is the in-process linker; the remote ``nahual_*``
steps need ``net/`` (ROADMAP queue 1, item 8)."""

from __future__ import annotations

import numpy as np


def dispatch_global_step(name: str, device=None, **params):
    if name.startswith("nahual_"):
        raise NotImplementedError(
            f"global step {name!r}: the remote clients of net/ (ROADMAP queue 1, item 8)")
    if name.startswith("track_global") or name == "trackastra":
        from aliby_tpu_torch.track.linker import link_tracks

        def process(stacked, **_):
            # get_step_output emits (n_fetchers, T, F, Y, X); callable fetchers
            # may give (T, F, Y, X) or (T, Y, X)
            stacked = np.asarray(stacked)
            if stacked.ndim == 5:
                stacked = stacked[0]
            return link_tracks(stacked, device=device, **(params.get("parameters") or {}))

        return process
    raise ValueError(f"Unknown global step {name!r}")
