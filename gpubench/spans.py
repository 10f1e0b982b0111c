"""The program's own spans (``aliby_tpu_torch.utils.profiling.span``), as
the per-layer metrics of source ``program_span`` read them.

With ``--trace 1`` the benchmark sets ``ALIBY_MESH_TIMING`` for the
window's passes alone, and ``run_positions_mesh`` turns the span recorder
on for each call it is set in: the totals cover the window's passes, as
the runner's logged split does. A span's ``device_s`` is its stream time:
the time between two timing events that the span records on the device's
current stream where its work is queued, so it holds the work's device
time and any wait of the stream on the host inside the span. A program
without the recorder, or a span that was not called, reads None.
"""

from __future__ import annotations


def _span(name: str) -> dict | None:
    from aliby_tpu_torch.utils import profiling

    totals = getattr(profiling, "totals", None)
    got = totals().get(name) if totals is not None else None
    return got if got and got["n"] else None


def ms_per_field(ctx: dict, name: str, key: str) -> float | None:
    """``key`` (``host_s`` or ``device_s``) of the span ``name`` over the
    window's fields, in ms."""
    got = _span(name)
    if got is None or got[key] is None:
        return None
    return got[key] * 1e3 / ctx["window_fields"]


def host_ms_per_call(name: str) -> float | None:
    """The span's host time over its calls, in ms."""
    got = _span(name)
    return None if got is None else got["host_s"] * 1e3 / got["n"]
