"""Stream time a field of the ``feret`` entries of the feature trees (span
``features.feret``) over the window's passes."""

from gpubench.spans import ms_per_field


def read(ctx):
    return ms_per_field(ctx, "features.feret", "device_s")
