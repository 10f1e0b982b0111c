"""Stream time a field of the zernike family, ``zernike`` and
``radial_zernikes`` in one pass (``texture.zernike_family_multi``; span
``features.zernike``), over the window's passes."""

from gpubench.spans import ms_per_field


def read(ctx):
    return ms_per_field(ctx, "features.zernike", "device_s")
