"""Label-map utilities (counterpart of ``aliby_tpu/ops/labels.py``).

This slice ports :func:`relabel_dense`, which the segmentation path uses.
"""

from __future__ import annotations

import torch


def relabel_dense(labels: torch.Tensor, upper: int, max_labels: int) -> torch.Tensor:
    """Compact positive labels known to lie in [0, upper) into 1..n per image.

    ``labels`` is (B, ...). Order is ascending original label; labels whose
    sequential id would exceed ``max_labels`` map to 0 (dropped).
    """
    B = labels.shape[0]
    flat = labels.reshape(B, -1)
    idx = flat.clamp(0, upper - 1).to(torch.int64)
    present = torch.zeros(B, upper, dtype=torch.int32, device=labels.device)
    present.scatter_reduce_(1, idx, (flat > 0).to(torch.int32), "amax")
    seq = torch.cumsum(present, dim=1, dtype=torch.int32)
    new = torch.gather(seq, 1, idx)
    new = torch.where((flat > 0) & (new <= max_labels), new, 0)
    return new.reshape(labels.shape).to(torch.int32)
