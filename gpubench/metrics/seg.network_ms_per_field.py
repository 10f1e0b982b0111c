"""Stream time a field of the network's forwards (inside
``CellposeTorch._forward``; span ``seg.network``) over the window's passes."""

from gpubench.spans import ms_per_field


def read(ctx):
    return ms_per_field(ctx, "seg.network", "device_s")
