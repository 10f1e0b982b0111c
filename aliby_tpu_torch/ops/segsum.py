"""Per-bin reductions (counterpart of ``aliby_tpu/ops/pallas_segsum.py``).

All four kernels of that module are ported: the batched
:func:`binned_sum_cols_batched`, :func:`binned_minmax_batched` and
:func:`table_lookup_batched`, which carry the feature bank, and the
unbatched :func:`segment_sum_matmul` (wrapper :func:`segment_sum_auto`),
which no production path calls, as in the reference.

Each wrapper runs its plain PyTorch version (``*_plain``) for CPU tensors
and launches its CUDA kernel (``kernels/csrc/segsum.cu``) for CUDA tensors;
there is no fallback between the two. ``<wrapper>.launches`` counts kernel
launches. A launch runs on its tensors' card, whatever the calling thread's
current device.

The two sum kernels take every sum in one fixed order: a left fold from
+0.0 over the bin's pixels of each ``CHUNK``-pixel chunk, in pixel order,
then a left fold of the chunk sums in chunk order. ``*_chunked`` computes
the same with plain PyTorch; on the CPU, where ``index_add_`` adds in index
order, it gives the kernel's bits (a test and smoke helper: no path of the
port calls it).
"""

from __future__ import annotations

import torch

from aliby_tpu_torch.kernels import _build

MAX_COLS = 32  # segsum.cu kMaxK
CHUNK = 4096  # segsum.cu kChunk: the sum kernels' chunk (their summation order)
MAX_ROWS = 2**31 - 1  # the sum kernels' run rows must stay below it (int32 row indices)
LOOKUP_CHUNK = 1024  # pixels per block of the lookup kernel: ~8 blocks per SM at 16 x 256^2
MINMAX_MAX_SLOTS = 4096  # n_bins * K: two int32 tables in 32 KB of shared memory
LOOKUP_MAX_SLOTS = 12288  # L * K: the f32 table staged in 48 KB of shared memory
MINMAX_TILE = 2048  # segsum.cu kTile: pixels a min/max block takes at a time
MINMAX_BLOCKS = 132 * 4  # min/max blocks in one wave on an H100 (132 SMs, 4 blocks each)
MINMAX_FOLD = 65536  # keys per table the last block of an image folds, at most


def _check_pair(values: torch.Tensor, bins: torch.Tensor) -> None:
    if bins.dim() < 1 or values.shape[:-1] != bins.shape:
        raise ValueError(
            f"values (B, ..., K) and bins (B, ...) disagree: "
            f"{tuple(values.shape)} vs {tuple(bins.shape)}"
        )
    if values.device != bins.device:
        raise ValueError("values and bins must share a device")
    _check_int(bins)


def _prep(values: torch.Tensor, bins: torch.Tensor):
    _check_pair(values, bins)
    B = bins.shape[0]
    K = values.shape[-1]
    vals = values.reshape(B, -1, K)
    if vals.dtype != torch.float32:
        vals = vals.float()
    return vals, bins.reshape(B, -1), B, vals.shape[1], K


def _check_int(bins: torch.Tensor) -> None:
    if bins.dtype.is_floating_point or bins.dtype == torch.bool:
        raise TypeError(f"bins must be integers, got {bins.dtype}")


def _device_of(t: torch.Tensor) -> str:
    if t.is_cuda:
        return "cuda"
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}")
    return "cpu"


def _int32_bins(flat: torch.Tensor, n_bins: int) -> torch.Tensor:
    if flat.dtype != torch.int32:
        # out-of-range bins (some beyond int32) become -1 before narrowing
        flat = torch.where((flat >= 0) & (flat < n_bins), flat, -1).to(torch.int32)
    return flat.contiguous()


def _flat_index(flat: torch.Tensor, n_bins: int) -> torch.Tensor:
    """(B, N) bins -> (B*N,) rows of a (B*n_bins + 1)-row table; bins
    outside [0, n_bins) land on the spare last row."""
    B = flat.shape[0]
    flat = flat.to(torch.int64)
    valid = (flat >= 0) & (flat < n_bins)
    base = torch.arange(B, device=flat.device).unsqueeze(1) * n_bins
    return torch.where(valid, flat + base, B * n_bins).reshape(-1)


def _index_add_sums(vals: torch.Tensor, flat: torch.Tensor, n_bins: int) -> torch.Tensor:
    B, K = flat.shape[0], vals.shape[-1]
    idx = _flat_index(flat, n_bins)
    out = torch.zeros(B * n_bins + 1, K, dtype=torch.float32, device=vals.device)
    out.index_add_(0, idx, vals.reshape(-1, K))
    return out[:-1].reshape(B, n_bins, K)


def binned_sum_cols_batched_plain(values: torch.Tensor, bins: torch.Tensor,
                                  n_bins: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`binned_sum_cols_batched`."""
    vals, flat, B, N, K = _prep(values, bins)
    return _index_add_sums(vals, flat, n_bins)


def binned_sum_cols_batched_chunked(values: torch.Tensor, bins: torch.Tensor,
                                    n_bins: int) -> torch.Tensor:
    """:func:`binned_sum_cols_batched_plain` in the kernel's order: each
    ``CHUNK``-pixel chunk summed on its own, then the chunk sums added from
    +0.0 in chunk order. On the CPU these are the kernel's bits."""
    vals, flat, B, N, K = _prep(values, bins)
    out = torch.zeros(B, n_bins, K, dtype=torch.float32, device=vals.device)
    for c0 in range(0, N, CHUNK):
        out = out + _index_add_sums(vals[:, c0:c0 + CHUNK], flat[:, c0:c0 + CHUNK], n_bins)
    return out


def _run_rows(B: int, N: int, n_bins: int) -> int:
    """Rows of run sums: a chunk has at most min(CHUNK, n_bins) runs (a
    run is a bin's pixels in one chunk)."""
    return B * -(-N // CHUNK) * min(CHUNK, n_bins)


def sum_scratch_sizes(B: int, N: int, K: int, n_bins: int) -> tuple[int, int, int]:
    """Element counts of the sum kernels' scratch (f32, int32, int64), as
    ``segsum.cu`` ``sum_runs`` lays it out: a row of K sums for each run;
    each run's bin and its place in its bin's list; per-chunk run counts;
    per-(image, bin) counts and offsets; the list of non-empty (image, bin)s."""
    rows, cells = _run_rows(B, N, n_bins), B * n_bins
    return rows * K, 2 + 2 * cells + B * -(-N // CHUNK) + 2 * rows, min(cells, rows)


def _launch_sums(entry: str, what: str, vals, flat, B: int, N: int, K: int, n_bins: int):
    """Run one of the sum kernels' C entries; (B, n_bins, K) f32."""
    if not 1 <= K <= MAX_COLS:
        raise ValueError(f"the kernel takes 1..{MAX_COLS} columns, got {K}")
    if n_bins < 1:
        raise ValueError(f"n_bins must be positive, got {n_bins}")
    if not 1 <= B <= 65535 or N < 1 or _run_rows(B, N, n_bins) >= MAX_ROWS:
        raise ValueError(f"the kernel takes 1..65535 images and fewer than {MAX_ROWS} run rows "
                         f"(images x chunks x min({CHUNK}, n_bins)), got B {B}, N {N}, "
                         f"n_bins {n_bins}")
    dev = vals.device
    n_f, n_i, n_l = sum_scratch_sizes(B, N, K, n_bins)
    # one allocation: the int64 list first, then the floats, then the ints
    scratch = torch.empty(2 * n_l + n_f + n_i, dtype=torch.int32, device=dev)
    out = torch.empty(B, n_bins, K, dtype=torch.float32, device=dev)
    lib = _build.load("segsum")
    base = scratch.data_ptr()
    args = (vals.data_ptr(), flat.data_ptr(), base + 8 * n_l, base + 8 * n_l + 4 * n_f, base,
            out.data_ptr())
    with _build.on_device(vals):
        if entry == "segment_sum":
            err = lib.segment_sum(*args, N, K, n_bins, _build.stream_of(vals))
        else:
            err = lib.binned_sum_cols(*args, B, N, K, n_bins, _build.stream_of(vals))
    _build.check(err, what)
    return out


def binned_sum_cols_batched(values: torch.Tensor, bins: torch.Tensor,
                            n_bins: int) -> torch.Tensor:
    """Batched per-bin sums: (B, ..., K) values, (B, ...) int bins ->
    (B, n_bins, K) f32, K <= 32 on CUDA. Bins outside [0, n_bins) add
    nothing. On CUDA the sums are deterministic: the order of
    :func:`binned_sum_cols_batched_chunked`, no float atomics; the work and
    the scratch follow the pixels, not n_bins."""
    if _device_of(values) == "cpu":
        return binned_sum_cols_batched_plain(values, bins, n_bins)
    vals, flat, B, N, K = _prep(values, bins)
    if N == 0:  # plain's zero tables, no launch
        return torch.zeros(B, n_bins, K, dtype=torch.float32, device=vals.device)
    out = _launch_sums("binned_sum_cols", "binned_sum_cols_batched", vals.contiguous(),
                       _int32_bins(flat, n_bins), B, N, K, n_bins)
    _build.count(binned_sum_cols_batched)
    return out


binned_sum_cols_batched.launches = 0


def _prep_segment(values: torch.Tensor, labels: torch.Tensor):
    if values.device != labels.device:
        raise ValueError("values and labels must share a device")
    _check_int(labels)
    flat_l = labels.reshape(-1)
    if flat_l.numel() == 0 or values.numel() % flat_l.numel():
        raise ValueError(
            f"values {tuple(values.shape)} do not give whole rows for "
            f"labels {tuple(labels.shape)}"
        )
    return values.reshape(flat_l.numel(), -1).to(torch.float32), flat_l


def segment_sum_matmul_plain(values: torch.Tensor, labels: torch.Tensor,
                             max_labels: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`segment_sum_matmul` (``index_add_``)."""
    vals, flat_l = _prep_segment(values, labels)
    flat_l = flat_l.to(torch.int64)
    valid = (flat_l >= 1) & (flat_l <= max_labels)
    idx = torch.where(valid, flat_l - 1, max_labels)  # dropped labels -> spare row
    out = torch.zeros(max_labels + 1, vals.shape[1], dtype=torch.float32, device=vals.device)
    out.index_add_(0, idx, vals)
    return out[:-1]


def segment_sum_matmul_chunked(values: torch.Tensor, labels: torch.Tensor,
                               max_labels: int) -> torch.Tensor:
    """:func:`segment_sum_matmul_plain` in the kernel's order (see
    :func:`binned_sum_cols_batched_chunked`); on the CPU the kernel's bits."""
    vals, flat_l = _prep_segment(values, labels)
    out = torch.zeros(max_labels, vals.shape[1], dtype=torch.float32, device=vals.device)
    for c0 in range(0, flat_l.numel(), CHUNK):
        out = out + segment_sum_matmul_plain(vals[c0:c0 + CHUNK], flat_l[c0:c0 + CHUNK],
                                             max_labels)
    return out


def segment_sum_matmul(values: torch.Tensor, labels: torch.Tensor,
                       max_labels: int) -> torch.Tensor:
    """Per-label sums of K value columns, unbatched: (N, K) values (or any
    shape that flattens to it) and (N,) int labels -> (max_labels, K) f32,
    label k in row k - 1. Label 0, negative labels and labels above
    ``max_labels`` add nothing. K <= 32 on CUDA, where the sums are
    deterministic: the order of :func:`segment_sum_matmul_chunked`.

    The reference's ``tile`` and ``interpret`` arguments are gone: the
    per-tile one-hot matmul (and its tile % 1024 rule) was the TPU's
    mechanism, and the kernel has no interpreter. A non-finite value reaches
    its own label's sum only (IEEE addition), where the reference's matmul
    made the whole column NaN for every label.
    """
    if _device_of(values) == "cpu":
        return segment_sum_matmul_plain(values, labels, max_labels)
    vals, flat_l = _prep_segment(values, labels)
    N, K = vals.shape
    if max_labels < 1:
        raise ValueError(f"max_labels must be positive, got {max_labels}")
    out = _launch_sums("segment_sum", "segment_sum_matmul", vals.contiguous(),
                       _int32_bins(flat_l, max_labels + 1), 1, N, K, max_labels)
    _build.count(segment_sum_matmul)
    return out[0]


segment_sum_matmul.launches = 0


def segment_sum_auto(values: torch.Tensor, labels: torch.Tensor, max_labels: int) -> torch.Tensor:
    """:func:`segment_sum_matmul` under the reference's wrapper name (there
    it picks the interpreter off the TPU; here the tensors' device decides)."""
    return segment_sum_matmul(values, labels, max_labels)


def binned_minmax_batched_plain(values: torch.Tensor, bins: torch.Tensor, n_bins: int):
    """Plain PyTorch version of :func:`binned_minmax_batched`
    (``scatter_reduce_`` amin/amax, NaN flags scattered beside them)."""
    vals, flat, B, N, K = _prep(values, bins)
    idx = _flat_index(flat, n_bins).unsqueeze(1).expand(-1, K)
    v = vals.reshape(-1, K)
    nan = torch.isnan(v)
    inf = torch.full((), float("inf"), device=v.device)
    rows = B * n_bins + 1
    mn = torch.full((rows, K), float("inf"), device=v.device)
    mn.scatter_reduce_(0, idx, torch.where(nan, inf, v), "amin")
    mx = torch.full((rows, K), float("-inf"), device=v.device)
    mx.scatter_reduce_(0, idx, torch.where(nan, -inf, v), "amax")
    flag = torch.zeros((rows, K), dtype=torch.int32, device=v.device)
    flag.scatter_reduce_(0, idx, nan.to(torch.int32), "amax")
    qnan = torch.full((), float("nan"), device=v.device)
    mn = torch.where(flag > 0, qnan, mn)[:-1].reshape(B, n_bins, K)
    mx = torch.where(flag > 0, qnan, mx)[:-1].reshape(B, n_bins, K)
    return mn, mx


_TICKETS: dict[tuple[int, int], torch.Tensor] = {}


def minmax_tickets(B: int, device: torch.device, stream: int) -> torch.Tensor:
    """The min/max kernel's per-image tickets for calls on ``stream``: one
    zeroed int32 array for each (device, stream), made at its first use
    (on that stream, so its zeroing runs before any kernel that reads it)
    and grown with B. The kernel's last block of each image sets its ticket
    back to 0, so calls on one stream reuse the array in order and calls on
    two streams never share a ticket."""
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < B:
        t = _TICKETS[key] = torch.zeros(max(B, 64), dtype=torch.int32, device=device)
    return t


def minmax_scratch(B: int, N: int, slots: int) -> tuple[int, int]:
    """Blocks per image of the min/max kernel and the int32 words of its
    scratch. Blocks: enough for ``MINMAX_BLOCKS`` over the call, no more
    than the image's tiles, and few enough that the last block's fold of
    the blocks' tables stays within ``MINMAX_FOLD`` keys (``slots`` =
    n_bins * K). Scratch: a table of 2 * slots keys per block, each rounded
    up to 16 bytes."""
    G = max(1, min(-(-N // MINMAX_TILE), -(-MINMAX_BLOCKS // B), MINMAX_FOLD // slots))
    return G, B * G * (-(-2 * slots // 4) * 4)


def binned_minmax_batched(values: torch.Tensor, bins: torch.Tensor, n_bins: int):
    """Batched per-bin (min, max) of each value column: (B, ..., K) values,
    (B, ...) int bins -> two (B, n_bins, K) f32. Empty bins hold
    (+inf, -inf); bins outside [0, n_bins) are dropped; a NaN value makes
    NaN in its own (bin, column) only. On CUDA ``n_bins * K`` is at most
    4096 (the kernel's shared-memory table), -0.0 counts as below +0.0, and
    a call is one launch."""
    if _device_of(values) == "cpu":
        return binned_minmax_batched_plain(values, bins, n_bins)
    _check_pair(values, bins)  # the kernel reads flat memory: no reshape
    B, K = bins.shape[0], values.shape[-1]
    if B < 1 or n_bins < 1 or K < 1:
        raise ValueError(f"B, n_bins and K must be positive, got {B}, {n_bins}, {K}")
    slots = n_bins * K
    if slots > MINMAX_MAX_SLOTS:
        raise ValueError(
            f"n_bins * K = {slots} exceeds the kernel's shared-memory table "
            f"({MINMAX_MAX_SLOTS} slots)"
        )
    vals = (values if values.dtype == torch.float32 else values.float()).contiguous()
    flat = _int32_bins(bins, n_bins)
    N = flat.numel() // B
    if N == 0:  # plain's (+inf, -inf) tables, no launch
        inf = torch.full((B, n_bins, K), float("inf"), device=vals.device)
        return inf, -inf
    G, n_part = minmax_scratch(B, N, slots)
    out = vals.new_empty((2, B, n_bins, K))
    part = flat.new_empty(n_part)
    lib = _build.load("segsum")
    mn = out.data_ptr()
    stream = _build.stream_of(vals)
    tickets = minmax_tickets(B, vals.device, stream)
    with _build.on_device(vals):
        _build.check(
            lib.binned_minmax(vals.data_ptr(), flat.data_ptr(), mn, mn + 4 * B * slots,
                              part.data_ptr(), tickets.data_ptr(), B, N, K, n_bins, G, stream),
            "binned_minmax_batched",
        )
    _build.count(binned_minmax_batched)
    return out.unbind(0)


binned_minmax_batched.launches = 0


def _prep_lookup(table: torch.Tensor, bins: torch.Tensor):
    if table.dim() != 3 or bins.dim() < 1 or bins.shape[0] != table.shape[0]:
        raise ValueError(
            f"table (B, L, K) and bins (B, ...) disagree: "
            f"{tuple(table.shape)} vs {tuple(bins.shape)}"
        )
    if table.device != bins.device:
        raise ValueError("table and bins must share a device")
    _check_int(bins)
    return table if table.dtype == torch.float32 else table.float()


def table_lookup_batched_plain(table: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`table_lookup_batched` (indexing)."""
    tab = _prep_lookup(table, bins)
    B, L, K = tab.shape
    flat = bins.reshape(B, -1).to(torch.int64)
    valid = (flat >= 0) & (flat < L)
    tab = torch.where(torch.isfinite(tab), tab, torch.full((), float("nan"), device=tab.device))
    got = torch.gather(tab, 1, flat.clamp(0, L - 1).unsqueeze(-1).expand(-1, -1, K))
    out = torch.where(valid.unsqueeze(-1), got, torch.zeros((), device=tab.device))
    return out.reshape(bins.shape + (K,))


def table_lookup_batched(table: torch.Tensor, bins: torch.Tensor) -> torch.Tensor:
    """Batched small-table lookup: (B, L, K) table, (B, ...) int bins ->
    (B, ..., K) f32 with ``out = table[bin]``. A bin outside [0, L) gives 0;
    a non-finite entry gives NaN on exactly the pixels (and the column)
    that read it, so +-inf becomes NaN as on the TPU kernel path. On CUDA
    ``L * K`` is at most 12288 (the table staged in shared memory)."""
    if _device_of(table) == "cpu":
        return table_lookup_batched_plain(table, bins)
    tab = _prep_lookup(table, bins).contiguous()
    B, L, K = tab.shape
    if B < 1 or L < 1 or K < 1:
        raise ValueError(f"empty table {tuple(tab.shape)}")
    if L * K > LOOKUP_MAX_SLOTS:
        raise ValueError(
            f"L * K = {L * K} exceeds the kernel's shared-memory table "
            f"({LOOKUP_MAX_SLOTS} slots)"
        )
    flat = _int32_bins(bins, L)
    N = flat.numel() // B
    out = tab.new_empty(bins.shape + (K,))
    if N:
        lib = _build.load("segsum")
        with _build.on_device(tab):
            _build.check(
                lib.table_lookup(tab.data_ptr(), flat.data_ptr(), out.data_ptr(), B, N, L, K,
                                 LOOKUP_CHUNK, _build.stream_of(tab)),
                "table_lookup_batched",
            )
        _build.count(table_lookup_batched)
    return out


table_lookup_batched.launches = 0
