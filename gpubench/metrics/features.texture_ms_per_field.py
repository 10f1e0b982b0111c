"""Stream time a field of the ``texture`` entries of the feature trees
(span ``features.texture``) over the window's passes."""

from gpubench.spans import ms_per_field


def read(ctx):
    return ms_per_field(ctx, "features.texture", "device_s")
