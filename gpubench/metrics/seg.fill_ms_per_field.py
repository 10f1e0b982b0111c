"""Stream time a field of the hole filling (``ops/labels.fill_label_holes``
as ``models/flows.masks_from_flows`` calls it; span ``seg.fill``, nested in
``seg.qc``) over the window's passes."""

from gpubench.spans import ms_per_field


def read(ctx):
    return ms_per_field(ctx, "seg.fill", "device_s")
