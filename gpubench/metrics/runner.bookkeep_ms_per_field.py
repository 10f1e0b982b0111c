"""Host self-time of the mesh runner's serial loop a field: its
``ALIBY_MESH_TIMING`` split's ``bookkeep`` (splitting results back per
position, saves, profile tables) plus ``finalize`` (profiles parquet),
summed over the window's passes, over the window's fields."""


def read(ctx):
    t = ctx["timing"]
    if not t or "bookkeep" not in t:
        return None
    return (t["bookkeep"] + t.get("finalize", 0.0)) * 1e3 / ctx["window_fields"]
