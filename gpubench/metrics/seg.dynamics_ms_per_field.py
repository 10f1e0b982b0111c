"""Stream time a field of the flow dynamics (``models/flows.follow_flows``
and ``masks_from_sinks``; span ``seg.dynamics``) over the window's passes."""

from gpubench.spans import ms_per_field


def read(ctx):
    return ms_per_field(ctx, "seg.dynamics", "device_s")
