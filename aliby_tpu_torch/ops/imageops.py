"""Exact order statistics and percentiles (counterpart of the selection part
of ``aliby_tpu/ops/imageops.py``).

Rows are the last axis; leading axes are a batch. Order statistics are
taken over the monotone uint32 encoding of IEEE-754 f32 (held in int64),
so the result is the exact array element the reference's bit-bisection
selects: -0.0 keys below +0.0, and a NaN selects as +huge.
"""

from __future__ import annotations

import numpy as np
import torch

_SIGN = 0x80000000
_MASK = 0xFFFFFFFF


def _monotone_key(x: torch.Tensor) -> torch.Tensor:
    """f32 -> int64 key in [0, 2^32) with the reference's total order."""
    u = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64) & _MASK
    return torch.where(u >= _SIGN, (~u) & _MASK, u | _SIGN)


def _key_to_f32(k: torch.Tensor) -> torch.Tensor:
    u = torch.where(k >= _SIGN, k ^ _SIGN, (~k) & _MASK)
    u = torch.where(u >= _SIGN, u - (1 << 32), u)  # two's complement int32
    return u.to(torch.int32).view(torch.float32)


def order_statistics(x: torch.Tensor, ranks: tuple[int, ...]) -> torch.Tensor:
    """Exact 0-indexed order statistics of each row: (..., n) f32 ->
    (..., len(ranks)) f32, bit-equal to the reference's selection."""
    keys, _ = torch.sort(_monotone_key(x), dim=-1)
    idx = torch.as_tensor(ranks, dtype=torch.int64, device=x.device)
    return _key_to_f32(keys.index_select(-1, idx))


def percentile_pair(x: torch.Tensor, q_lo: float, q_hi: float):
    """(lo, hi) linearly interpolated percentiles of each row of (..., n).

    NumPy's convention as the reference spells it: float64 index arithmetic
    ``q/100*(n-1)`` on the host, then an f32 lerp ``a + (b-a)*t``."""
    n = int(x.shape[-1])
    idx = [float(q) / 100.0 * (n - 1) for q in (q_lo, q_hi)]
    lo_r = [int(np.floor(i)) for i in idx]
    hi_r = [int(np.ceil(i)) for i in idx]
    t = [float(np.float32(i - np.floor(i))) for i in idx]
    vals = order_statistics(x, (lo_r[0], hi_r[0], lo_r[1], hi_r[1]))
    out_lo = vals[..., 0] + (vals[..., 1] - vals[..., 0]) * t[0]
    out_hi = vals[..., 2] + (vals[..., 3] - vals[..., 2]) * t[1]
    return out_lo, out_hi
