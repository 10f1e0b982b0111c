"""Stream time a field of the flow-error QC, the size drops, compaction and
hole filling (``models/flows.masks_from_flows``; span ``seg.qc``) over
the window's passes."""

from gpubench.spans import ms_per_field


def read(ctx):
    return ms_per_field(ctx, "seg.qc", "device_s")
