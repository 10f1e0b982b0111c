"""``successor_prop`` and ``diffuse_heat`` (``ops/stencil``,
``kernels/csrc/stencil.cu``) as ``models/flows`` calls them: their share of
the roofline in the traced pass."""

from gpubench.trace import roofline_share


def read(ctx):
    return roofline_share(ctx, ("successor_prop", "diffuse_heat"))
