"""Host time a field of queueing the fused step's second half, every
feature tree (``features_phase``; span ``step.enqueue``), over the
window's passes."""

from gpubench.spans import ms_per_field


def read(ctx):
    return ms_per_field(ctx, "step.enqueue", "host_s")
