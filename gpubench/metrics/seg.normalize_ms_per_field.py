"""Stream time a field of the exact-percentile normalisation
(``models/segment._normalize_percentile``; span ``seg.normalize``) over
the window's passes."""

from gpubench.spans import ms_per_field


def read(ctx):
    return ms_per_field(ctx, "seg.normalize", "device_s")
