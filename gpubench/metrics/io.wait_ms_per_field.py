"""Time the runner's dispatch thread waited for the IO pool (TIFF decode,
tiling) a field: the ``ALIBY_MESH_TIMING`` split's ``io_wait`` over the
window's passes, over the window's fields."""


def read(ctx):
    t = ctx["timing"]
    if not t or "io_wait" not in t:
        return None
    return t["io_wait"] * 1e3 / ctx["window_fields"]
