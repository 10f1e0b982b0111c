"""Lazy n-d array views, the dask replacement of the data plane
(counterpart of ``aliby_tpu/io/lazy.py``).

The reference assembles 5-D ``TCZYX`` stacks as dask graphs computed one frame
at a time with ``scheduler="synchronous"`` (``aliby/io/image.py``,
``tile/tiler.py:460-487``). Here the lazy layer is a minimal index-translation
view system: any object with ``shape``/``dtype``/``__getitem__`` (numpy, a
zarr-lite array, a file-grid of TIFFs) can be squeezed / expanded / transposed
without materialization, and frames are pulled on demand with an LRU cache
plus an optional background prefetch thread (double-buffering the next
timepoint while the device computes the current one).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Any, Callable, Sequence

import numpy as np

Index = int | slice


def _normalize_index(idx, ndim: int) -> tuple[Index, ...]:
    """Expand an index into a per-axis tuple of ints/slices (no Ellipsis left)."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    if Ellipsis in idx:
        pos = idx.index(Ellipsis)
        n_missing = ndim - (len(idx) - 1)
        idx = idx[:pos] + (slice(None),) * n_missing + idx[pos + 1 :]
    if len(idx) > ndim:
        raise IndexError(f"too many indices ({len(idx)}) for {ndim}-d array")
    idx = idx + (slice(None),) * (ndim - len(idx))
    out = []
    for ax, i in enumerate(idx):
        if isinstance(i, (int, np.integer)):
            out.append(int(i))
        elif isinstance(i, slice):
            out.append(i)
        else:
            raise TypeError(f"unsupported index {i!r} on axis {ax}")
    return tuple(out)


def _sliced_len(s: slice, size: int) -> int:
    return len(range(*s.indices(size)))


class LazyView:
    """An axis-remapping view over an indexable source.

    ``axis_of[i]`` names the source axis backing view axis ``i`` (or ``None``
    for an inserted length-1 axis); ``fixed`` pins source axes that were
    squeezed out to a constant index.
    """

    def __init__(self, source, axis_of: Sequence[int | None], fixed: dict[int, int] | None = None):
        self.source = source
        self.axis_of = list(axis_of)
        self.fixed = dict(fixed or {})
        src_shape = source.shape
        self.shape = tuple(
            1 if ax is None else src_shape[ax] for ax in self.axis_of
        )
        self.dtype = source.dtype
        self.ndim = len(self.shape)

    def __getitem__(self, idx) -> np.ndarray:
        idx = _normalize_index(idx, self.ndim)
        src_ndim = len(self.source.shape)
        src_index: list[Index] = [slice(None)] * src_ndim
        for ax, val in self.fixed.items():
            src_index[ax] = val
        # view axes that survive indexing (sliced, not int-indexed)
        kept_view_axes = []
        inserted_positions = []  # positions among kept axes that are virtual
        for view_ax, (src_ax, i) in enumerate(zip(self.axis_of, idx)):
            if src_ax is None:
                if isinstance(i, int):
                    if i not in (0, -1):
                        raise IndexError("index out of range on length-1 axis")
                else:
                    kept_view_axes.append(view_ax)
                    inserted_positions.append(len(kept_view_axes) - 1)
                continue
            src_index[src_ax] = i
            if isinstance(i, slice):
                kept_view_axes.append(view_ax)
        raw = self.source[tuple(src_index)]
        raw = np.asarray(raw)
        # raw dims correspond to source axes that received slices, in source order
        sliced_src_axes = [
            ax for ax in range(src_ndim)
            if isinstance(src_index[ax], slice)
        ]
        # Build output: for each kept view axis in order, find its raw dim.
        out_order = []
        for view_ax in kept_view_axes:
            src_ax = self.axis_of[view_ax]
            if src_ax is None:
                out_order.append(None)
            else:
                out_order.append(sliced_src_axes.index(src_ax))
        real_order = [d for d in out_order if d is not None]
        raw = np.transpose(raw, real_order) if real_order != sorted(real_order) else raw
        # After transpose, real dims are in view order; insert virtual axes.
        result = raw
        for pos, d in enumerate(out_order):
            if d is None:
                result = np.expand_dims(result, pos)
        return result


def lazy_squeeze(arr, axis: int):
    if isinstance(arr, np.ndarray):
        return np.squeeze(arr, axis)
    ndim = len(arr.shape)
    axis_of = [ax for ax in range(ndim) if ax != axis]
    if isinstance(arr, LazyView):
        # compose: re-point through to the underlying source
        new_axis_of = [arr.axis_of[ax] for ax in axis_of]
        fixed = dict(arr.fixed)
        if arr.axis_of[axis] is not None:
            fixed[arr.axis_of[axis]] = 0
        return LazyView(arr.source, new_axis_of, fixed)
    return LazyView(arr, axis_of, {axis: 0})


def lazy_expand_last(arr):
    if isinstance(arr, np.ndarray):
        return arr[..., np.newaxis]
    if isinstance(arr, LazyView):
        return LazyView(arr.source, arr.axis_of + [None], arr.fixed)
    return LazyView(arr, list(range(len(arr.shape))) + [None])


def lazy_moveaxis(arr, src_order: Sequence[int]):
    """Reorder axes so result axis ``i`` is input axis ``src_order[i]``."""
    if isinstance(arr, np.ndarray):
        return np.transpose(arr, src_order)
    if isinstance(arr, LazyView):
        return LazyView(arr.source, [arr.axis_of[ax] for ax in src_order], arr.fixed)
    return LazyView(arr, list(src_order))


class FileGridArray:
    """N files laid out on a grid of cross-file dims, each holding in-file dims.

    shape = (*grid_shape, *file_shape). Loading is per-file with a small LRU.
    Reference counterpart: the object-ndarray + ``da.block`` assembly in
    ``aliby/io/image.py:377-456``.
    """

    def __init__(
        self,
        grid_shape: tuple[int, ...],
        file_shape: tuple[int, ...],
        dtype,
        loader: Callable[[int], np.ndarray],
        cache_size: int = 8,
    ):
        self.grid_shape = tuple(grid_shape)
        self.file_shape = tuple(file_shape)
        self.shape = self.grid_shape + self.file_shape
        self.dtype = dtype
        self._loader = loader
        self._cache: OrderedDict[int, np.ndarray] = OrderedDict()
        self._cache_size = cache_size
        self._lock = threading.Lock()

    def _load(self, flat_idx: int) -> np.ndarray:
        with self._lock:
            if flat_idx in self._cache:
                self._cache.move_to_end(flat_idx)
                return self._cache[flat_idx]
        arr = np.asarray(self._loader(flat_idx))
        if arr.shape != self.file_shape:
            arr = arr.reshape(self.file_shape)
        with self._lock:
            self._cache[flat_idx] = arr
            while len(self._cache) > self._cache_size:
                self._cache.popitem(last=False)
        return arr

    def prefetch(self, grid_idx: tuple[int, ...]) -> None:
        flat = int(np.ravel_multi_index(grid_idx, self.grid_shape))
        threading.Thread(target=self._load, args=(flat,), daemon=True).start()

    def __getitem__(self, idx) -> np.ndarray:
        idx = _normalize_index(idx, len(self.shape))
        g = len(self.grid_shape)
        grid_idx, file_idx = idx[:g], idx[g:]
        grid_ranges = []
        grid_is_int = []
        for ax, i in enumerate(grid_idx):
            if isinstance(i, int):
                size = self.grid_shape[ax]
                i = i if i >= 0 else i + size
                grid_ranges.append([i])
                grid_is_int.append(True)
            else:
                grid_ranges.append(list(range(*i.indices(self.grid_shape[ax]))))
                grid_is_int.append(False)
        sample_file_out = None
        blocks = {}
        for combo in np.ndindex(*[len(r) for r in grid_ranges]):
            cell = tuple(grid_ranges[ax][combo[ax]] for ax in range(g))
            flat = int(np.ravel_multi_index(cell, self.grid_shape)) if g else 0
            block = self._load(flat)[tuple(file_idx)]
            if sample_file_out is None:
                sample_file_out = np.asarray(block).shape
            blocks[combo] = block
        out = np.empty(
            tuple(len(r) for r in grid_ranges) + tuple(sample_file_out),
            dtype=self.dtype,
        )
        for combo, block in blocks.items():
            out[combo] = block
        # Drop int-indexed grid dims.
        squeeze_axes = tuple(ax for ax, isint in enumerate(grid_is_int) if isint)
        for ax in sorted(squeeze_axes, reverse=True):
            out = np.squeeze(out, ax)
        return out
