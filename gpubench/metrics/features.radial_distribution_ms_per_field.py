"""Stream time a field of the ``radial_distribution`` entries of the
feature trees (span ``features.radial_distribution``) over the window's
passes."""

from gpubench.spans import ms_per_field


def read(ctx):
    return ms_per_field(ctx, "features.radial_distribution", "device_s")
