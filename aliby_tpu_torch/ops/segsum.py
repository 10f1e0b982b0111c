"""Batched per-bin reductions (counterpart of ``aliby_tpu/ops/pallas_segsum.py``).

This slice ports :func:`binned_sum_cols_batched`; the min/max and
table-lookup kernels of that module come with the feature bank.

The wrapper runs its plain PyTorch version for CPU tensors and launches
the CUDA kernel (``kernels/csrc/segsum.cu``) for CUDA tensors; there is no
fallback between the two. ``binned_sum_cols_batched.launches`` counts
kernel launches.
"""

from __future__ import annotations

import torch

from aliby_tpu_torch.kernels import _build

MAX_COLS = 8  # segsum.cu kMaxK
CHUNK = 4096  # pixels per block in the kernel's first pass


def _prep(values: torch.Tensor, bins: torch.Tensor):
    if bins.dim() < 1 or values.shape[:-1] != bins.shape:
        raise ValueError(
            f"values (B, ..., K) and bins (B, ...) disagree: "
            f"{tuple(values.shape)} vs {tuple(bins.shape)}"
        )
    if values.device != bins.device:
        raise ValueError("values and bins must share a device")
    if bins.dtype.is_floating_point or bins.dtype == torch.bool:
        raise TypeError(f"bins must be integers, got {bins.dtype}")
    B = bins.shape[0]
    K = values.shape[-1]
    vals = values.reshape(B, -1, K).to(torch.float32)
    return vals, bins.reshape(B, -1), B, vals.shape[1], K


def binned_sum_cols_batched_plain(values: torch.Tensor, bins: torch.Tensor,
                                  n_bins: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`binned_sum_cols_batched`."""
    vals, flat, B, N, K = _prep(values, bins)
    flat = flat.to(torch.int64)
    valid = (flat >= 0) & (flat < n_bins)
    base = torch.arange(B, device=flat.device).unsqueeze(1) * n_bins
    # out-of-range bins land on one spare row past the end, then dropped
    idx = torch.where(valid, flat + base, B * n_bins).reshape(-1)
    out = torch.zeros(B * n_bins + 1, K, dtype=torch.float32, device=vals.device)
    out.index_add_(0, idx, vals.reshape(-1, K))
    return out[:-1].reshape(B, n_bins, K)


def binned_sum_cols_batched(values: torch.Tensor, bins: torch.Tensor,
                            n_bins: int) -> torch.Tensor:
    """Batched per-bin sums: (B, ..., K) values, (B, ...) int bins ->
    (B, n_bins, K) f32. Bins outside [0, n_bins) add nothing. On CUDA the
    sums are deterministic (fixed order, no atomics)."""
    if values.device.type == "cpu":
        return binned_sum_cols_batched_plain(values, bins, n_bins)
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")
    vals, flat, B, N, K = _prep(values, bins)
    if not 1 <= K <= MAX_COLS:
        raise ValueError(f"the kernel takes 1..{MAX_COLS} columns, got {K}")
    if n_bins < 1:
        raise ValueError(f"n_bins must be positive, got {n_bins}")
    vals = vals.contiguous()
    if flat.dtype != torch.int32:
        # out-of-range bins (some beyond int32) become -1 before narrowing
        flat = torch.where((flat >= 0) & (flat < n_bins), flat, -1).to(torch.int32)
    flat = flat.contiguous()
    n_chunks = -(-N // CHUNK)
    partial = torch.empty(B * n_chunks * n_bins * K, dtype=torch.float32, device=vals.device)
    out = torch.empty(B, n_bins, K, dtype=torch.float32, device=vals.device)
    lib = _build.load("segsum")
    _build.check(
        lib.binned_sum_cols(vals.data_ptr(), flat.data_ptr(), partial.data_ptr(),
                            out.data_ptr(), B, N, K, n_bins, CHUNK,
                            _build.stream_of(vals)),
        "binned_sum_cols_batched",
    )
    binned_sum_cols_batched.launches += 1
    return out


binned_sum_cols_batched.launches = 0
