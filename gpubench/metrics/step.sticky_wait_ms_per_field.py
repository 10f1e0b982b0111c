"""Host time a field that the fused step's dispatch blocks on the largest
label's readback after segmentation (``int(labels_pack.max())``, the
sticky width; span ``step.sticky_wait``) over the window's passes."""

from gpubench.spans import ms_per_field


def read(ctx):
    return ms_per_field(ctx, "step.sticky_wait", "host_s")
