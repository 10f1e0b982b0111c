"""Peak device memory allocated after set-up (``max_memory_allocated``
after ``reset_peak_memory_stats``), the fullest card, in GB."""

import torch


def read(ctx):
    cards = [d for d in ctx["devices"] if str(d).startswith("cuda")]
    if not cards:
        return None
    return max(torch.cuda.max_memory_allocated(d) for d in cards) / 1e9
