"""Stream time a field of the colocalisation pairs of the feature trees
(span ``features.coloc``) over the window's passes."""

from gpubench.spans import ms_per_field


def read(ctx):
    return ms_per_field(ctx, "features.coloc", "device_s")
