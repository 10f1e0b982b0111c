"""The whole step's share of the card's peak: the network's FLOPs a field
(``gpubench/flops.py``, from the configuration's widths) times the
window's fields, over the window's time, over the published H100 peak of
the configuration's compute precision (``gpubench/peaks.json``), averaged
over the cards."""

from gpubench.flops import field_flops
from gpubench.roofline import PEAKS

PEAK = {"bfloat16": "bf16_flops_s", "float32": "f32_flops_s"}


def read(ctx):
    cfg = ctx["config"]
    peak = PEAKS[PEAK[cfg["network"]["dtype"]]] * len(ctx["devices"])
    return 100.0 * field_flops(cfg) * ctx["window_fields"] / ctx["window_s"] / peak
