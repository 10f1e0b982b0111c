"""Stream time a field of the ``sizeshape`` entries of the feature trees
(span ``features.sizeshape``) over the window's passes."""

from gpubench.spans import ms_per_field


def read(ctx):
    return ms_per_field(ctx, "features.sizeshape", "device_s")
