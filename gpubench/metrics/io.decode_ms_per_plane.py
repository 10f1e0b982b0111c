"""Host time of one image plane read and decoded (``io/image.
_read_image_file``: the native TIFF decoder; span ``io.decode``), on the
IO pool's threads, over the window's passes."""

from gpubench.spans import host_ms_per_call


def read(ctx):
    return host_ms_per_call("io.decode")
