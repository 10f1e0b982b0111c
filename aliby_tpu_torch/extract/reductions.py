"""Per-label reductions (counterpart of ``aliby_tpu/extract/reductions.py``).

This slice ports :func:`binned_sum_cols`, which the mask-QC sums use; the
rest of the module comes with the feature bank.
"""

from __future__ import annotations

import torch

from aliby_tpu_torch.ops.segsum import binned_sum_cols_batched


def binned_sum_cols(values: torch.Tensor, bins: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Batched per-bin sums: (B, ..., K) values, (B, ...) int bins ->
    (B, n_bins, K), bin 0 kept, bins outside [0, n_bins) dropped.

    Non-finite values follow the reference's kernel path
    (``_binned_sum_kernel_call``): they ride a sanitised column plus an
    indicator column, and a bin that received any non-finite value holds
    NaN in all K columns (an ``+inf`` input gives NaN, not ``+inf``). The
    same rule holds on the CPU and the GPU.
    """
    values = values.to(torch.float32)
    finite = torch.isfinite(values)
    clean = torch.where(finite, values, torch.zeros((), device=values.device))
    flag = (~finite).any(dim=-1, keepdim=True).to(torch.float32)
    out = binned_sum_cols_batched(torch.cat([clean, flag], dim=-1), bins, int(n_bins))
    nan = torch.full((), float("nan"), device=values.device)
    return torch.where(out[..., -1:] > 0, nan, out[..., :-1])
