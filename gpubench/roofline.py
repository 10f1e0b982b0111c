"""The least time a kernel call could take on the card, from the call's
shapes and inputs whatever implements it: the larger of its bytes over the
memory bandwidth and its operations over the compute peak. Each input byte
is counted once and each output byte once.

The operation counts and the peaks are those that ``chip_smoke.py``'s
kernel table used (``measure_kernels``, ``binned_sum_row``):

- ``successor_prop``: 12 bytes a pixel (the code and key in, the key out),
  one operation a pixel and round, at the f32 peak;
- ``diffuse_heat``: 12 bytes a pixel (labels and sources in, heat out);
  per round, one f32 instruction for each same-label neighbour of a
  foreground pixel, one for each non-zero source, and 3 a foreground pixel
  for the correctly rounded division by 9, at the f32 instruction rate
  (an FMA is one instruction);
- ``binned_sum_cols_batched``: the values and bins in, one sum a bin and
  column out; one addition a value;
- ``binned_minmax_batched``: the values and bins in, a minimum and a
  maximum a bin and column out; two comparisons a value;
- ``table_lookup_batched``: the bins and the table in, one row of the
  table a pixel out; no arithmetic.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())
PEAK_BYTES_S = PEAKS["hbm_bytes_s"]
PEAK_F32_OPS_S = PEAKS["f32_flops_s"]
PEAK_F32_INSTR_S = PEAK_F32_OPS_S / 2  # an FMA is two operations and one instruction
DIFFUSE_DIV_INSTR = 3
OFFSETS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)]


def least_seconds(bytes_: float, ops: float, ops_rate: float = PEAK_F32_OPS_S) -> float:
    return max(bytes_ / PEAK_BYTES_S, ops / ops_rate)


def _numel(t) -> int:
    n = 1
    for s in t.shape:
        n *= int(s)
    return n


def successor_prop(dcode, key0, n_prop: int = 96, *_a, **_k) -> float:
    px = _numel(dcode)
    return least_seconds(12 * px, n_prop * px)


def diffuse_counts(labels, source) -> tuple[int, int, int]:
    """(foreground pixels, same-label neighbour pairs of foreground pixels,
    non-zero sources) of a ``diffuse_heat`` call's inputs."""
    import torch

    fg = labels > 0
    pad = torch.nn.functional.pad(labels, (1, 1, 1, 1), value=-1)
    H, W = labels.shape[-2:]
    n_same = 0
    for dy, dx in OFFSETS:
        n_same += int(((pad[..., 1 + dy:H + 1 + dy, 1 + dx:W + 1 + dx] == labels) & fg).sum())
    return int(fg.sum()), n_same, int((source != 0).sum())


def diffuse_heat(labels, source, n_iter: int = 96, counts=None) -> float:
    n_fg, n_same, n_src = counts if counts is not None else diffuse_counts(labels, source)
    return least_seconds(12 * _numel(labels),
                         n_iter * (n_same + n_src + n_fg * DIFFUSE_DIV_INSTR), PEAK_F32_INSTR_S)


def binned_sum_cols_batched(vals, bins, n_bins: int, *_a, **_k) -> float:
    B, K = bins.shape[0], vals.shape[-1]
    N = _numel(bins) // B
    bytes_ = B * N * (vals.element_size() * K + bins.element_size()) + B * n_bins * K * 4
    return least_seconds(bytes_, B * N * K)


def binned_minmax_batched(vals, bins, n_bins: int, *_a, **_k) -> float:
    B, K = bins.shape[0], vals.shape[-1]
    N = _numel(bins) // B
    bytes_ = B * N * (vals.element_size() * K + bins.element_size()) + 2 * B * n_bins * K * 4
    return least_seconds(bytes_, 2 * B * N * K)


def table_lookup_batched(table, bins, *_a, **_k) -> float:
    B, L, K = table.shape
    N = _numel(bins) // B
    return least_seconds(B * N * bins.element_size() + B * N * K * table.element_size()
                         + B * L * K * table.element_size(), 0)


LEAST = {"successor_prop": successor_prop, "diffuse_heat": diffuse_heat,
         "binned_sum_cols_batched": binned_sum_cols_batched,
         "binned_minmax_batched": binned_minmax_batched,
         "table_lookup_batched": table_lookup_batched}
