"""Device time a field of the operations launched inside ``tree_collect``
(every feature tree of the bank) in the traced pass."""

from gpubench.trace import TREE


def read(ctx):
    tr = ctx.get("trace")
    ms = tr and tr["range_ms"].get(TREE)
    return ms / ctx["traced_fields"] if ms else None
