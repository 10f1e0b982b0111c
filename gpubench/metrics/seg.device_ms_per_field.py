"""Device time a field of the operations launched inside the engines'
``_segment_all`` (normalisation, network, mask reconstruction, QC) in the
traced pass."""

from gpubench.trace import SEG


def read(ctx):
    tr = ctx.get("trace")
    ms = tr and tr["range_ms"].get(SEG)
    return ms / ctx["traced_fields"] if ms else None
