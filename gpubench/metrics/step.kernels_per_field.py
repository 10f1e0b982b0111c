"""CUDA kernels of the traced pass (memory copies and sets not counted)
over its fields."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr or not tr["kernels"]:
        return None
    return tr["kernels"] / ctx["traced_fields"]
