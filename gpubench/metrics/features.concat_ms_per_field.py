"""Stream time a field of the feature trees' concatenations: the labels and
images of trees that share a plan, each tree's stack of its values and
the step's block of every tree (span ``features.concat``), over the
window's passes."""

from gpubench.spans import ms_per_field


def read(ctx):
    return ms_per_field(ctx, "features.concat", "device_s")
