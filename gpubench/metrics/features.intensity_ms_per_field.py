"""Stream time a field of the ``intensity`` entries of the feature trees
(span ``features.intensity``) over the window's passes."""

from gpubench.spans import ms_per_field


def read(ctx):
    return ms_per_field(ctx, "features.intensity", "device_s")
