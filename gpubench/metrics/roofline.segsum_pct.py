"""``binned_sum_cols_batched``, ``binned_minmax_batched`` and
``table_lookup_batched`` (``ops/segsum``, ``kernels/csrc/segsum.cu``) as
``extract/reductions``, ``extract/features`` and ``models/flows`` call them:
their share of the roofline in the traced pass."""

from gpubench.trace import roofline_share


def read(ctx):
    return roofline_share(ctx, ("binned_sum_cols_batched", "binned_minmax_batched",
                                "table_lookup_batched"))
