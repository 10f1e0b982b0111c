"""The traced pass: ranges that the benchmark opens around the program's
layers, and the reduction of ``torch.profiler``'s raw events to what the
per-layer metrics read.

The benchmark wraps, for the length of one pass, the names through which
the program calls its layers, each call in a ``record_function`` range:

- ``gpubench.seg``: each engine's ``CellposeTorch._segment_all``
  (normalisation, the network, the mask reconstruction and its QC);
- ``gpubench.tree``: ``tree_collect`` as ``engine/fused`` calls it;
- ``gpubench.k.<kernel>``: ``successor_prop`` and ``diffuse_heat`` as
  ``models/flows`` calls them, and ``binned_sum_cols_batched``,
  ``binned_minmax_batched`` and ``table_lookup_batched`` as
  ``extract/reductions``, ``extract/features`` and ``models/flows`` (through
  ``reductions``) call them; each call's least time is recorded
  (``gpubench/roofline.py``).

A device operation belongs to a range when the CUDA runtime or driver call
that launched it (the host event with the same correlation id) ran on the
range's thread inside the range; a kernel launched from a library through
``ctypes`` has no aten op around it, only its runtime call and the range. The raw events are read from the
profiler's results directly: the profiler's own per-event Python objects
of a pass of ~10^5 kernels would take longer to build than the pass.
"""

from __future__ import annotations

import bisect
import contextlib
import threading
from collections import defaultdict

import torch
from torch.profiler import record_function

from gpubench import roofline

PASS = "gpubench.pass"
SEG = "gpubench.seg"
TREE = "gpubench.tree"
KERNEL = "gpubench.k."
COPY_PREFIXES = ("Memcpy", "Memset")
RUNTIME_PREFIXES = ("cuda", "cu")


class Ranges:
    """Wraps the program's layer entry points in ranges for one pass and
    keeps each kernel call's arguments for its least time."""

    def __init__(self):
        self.least = defaultdict(float)  # kernel -> summed least seconds
        self.calls = defaultdict(int)
        self._diffuse = []  # diffuse_heat's inputs: its least time depends on them
        self._lock = threading.Lock()
        self._stack = contextlib.ExitStack()

    def _wrap(self, module, attr: str, range_name: str, kernel: str | None = None):
        fn = getattr(module, attr)

        def wrapped(*args, **kwargs):
            with record_function(range_name):
                out = fn(*args, **kwargs)
            if kernel == "diffuse_heat":
                with self._lock:  # counted after the pass, off the traced timeline
                    self._diffuse.append((args, kwargs))
            elif kernel is not None:
                least = roofline.LEAST[kernel](*args, **kwargs)  # shapes alone
                with self._lock:
                    self.least[kernel] += least
                    self.calls[kernel] += 1
            return out

        setattr(module, attr, wrapped)
        self._stack.callback(setattr, module, attr, fn)

    def __enter__(self):
        from aliby_tpu_torch.engine import fused
        from aliby_tpu_torch.extract import features, reductions
        from aliby_tpu_torch.models import flows, segment

        engine = segment.CellposeTorch
        seg = engine._segment_all

        def segment_all(self_, images):
            with record_function(SEG):
                return seg(self_, images)

        engine._segment_all = segment_all
        self._stack.callback(setattr, engine, "_segment_all", seg)
        self._wrap(fused, "tree_collect", TREE)
        for module, name in ((flows, "successor_prop"), (flows, "diffuse_heat"),
                             (reductions, "binned_sum_cols_batched"),
                             (reductions, "binned_minmax_batched"),
                             (reductions, "table_lookup_batched"),
                             (features, "binned_sum_cols_batched")):
            self._wrap(module, name, KERNEL + name, kernel=name)
        return self

    def __exit__(self, *exc):
        self._stack.close()

    def least_seconds(self, names) -> tuple[float, int]:
        """Sum of the least times of the recorded calls of ``names``, and
        their number."""
        for args, kwargs in self._diffuse:
            self.least["diffuse_heat"] += roofline.LEAST["diffuse_heat"](*args, **kwargs)
            self.calls["diffuse_heat"] += 1
        self._diffuse = []
        return sum(self.least[n] for n in names), sum(self.calls[n] for n in names)


def _union(intervals, lo: int, hi: int) -> tuple[int, list]:
    """Length of the union of ``intervals`` clipped to [lo, hi] and the
    gaps between them, as (start, end) pairs."""
    busy, gaps, cur = 0, [], lo
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s or e <= cur:
            continue
        if s > cur:
            gaps.append((cur, s))
            busy += e - s
        else:
            busy += e - cur
        cur = e
    if cur < hi:
        gaps.append((cur, hi))
    return busy, gaps


class _Intervals:
    """Host ranges of one thread (properly nested, as a thread's ops are),
    for 'which ranges were open at t'."""

    def __init__(self, items):
        self.items = sorted(items, key=lambda it: (it[0], -it[1]))  # (start, end, name)
        self.starts = [s for s, _, _ in self.items]
        self.parent = []
        stack = []
        for i, (s, e, _) in enumerate(self.items):
            while stack and self.items[stack[-1]][1] <= s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def enclosing(self, t: int) -> list:
        """The ranges open at ``t``, outermost first."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.items[i][1] <= t:
            i = self.parent[i]
        chain = []
        while i >= 0:
            chain.append(self.items[i])
            i = self.parent[i]
        return chain[::-1]


def _annotation(e) -> bool:
    """A range's mirror on the device's timeline (kineto's
    ``gpu_user_annotation``), which is no device operation."""
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag and flag()) or e.name().startswith("gpubench.")


def reduce_events(prof) -> dict:
    """The traced pass from the profiler's raw events: device operations
    by card, the pass's window, and each benchmark range's device time."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    launches = {}  # correlation id -> (thread, start ns)
    ops_by_corr = {}
    host = defaultdict(list)  # thread -> [(start, end, name)]
    device = []  # (card, start, end, name, correlation, linked op)
    for e in events:
        if e.device_type() == DeviceType.CPU:
            # CUDA runtime and driver calls (cudaLaunchKernel, cuLaunchKernel,
            # ...), keyed by the correlation id they share with the device
            # operation they launched; the rest are ops and ranges
            if e.name().startswith(RUNTIME_PREFIXES):
                launches[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
            else:
                item = (e.start_ns(), e.end_ns(), e.name())
                host[e.start_thread_id()].append(item)
                ops_by_corr[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
        elif e.device_type() == DeviceType.CUDA and not _annotation(e):
            device.append((e.device_index(), e.start_ns(), e.end_ns(), e.name(),
                           e.correlation_id(), e.linked_correlation_id()))
    windows = [(s, e, tid) for tid, items in host.items() for s, e, n in items if n == PASS]
    if not windows:
        raise RuntimeError("the traced pass has no range of its own")
    lo, hi, main = windows[0]
    ranges = {name: defaultdict(list) for name in (SEG, TREE)}
    for tid, items in host.items():
        for s, e, n in items:
            if n in ranges:
                ranges[n][tid].append((s, e))
            elif n.startswith(KERNEL):
                ranges.setdefault(n, defaultdict(list))[tid].append((s, e))
    index = {n: {tid: _Intervals([(s, e, n) for s, e in v]) for tid, v in per.items()}
             for n, per in ranges.items()}

    def launched_in(at, name) -> bool:
        per = index[name].get(at[0])
        return per is not None and bool(per.enclosing(at[1]))

    by_card = defaultdict(list)
    kernels = 0
    unlaunched = 0
    op_time = defaultdict(float)
    range_ms = defaultdict(float)
    range_n = defaultdict(int)
    for card, s, e, name, corr, linked in device:
        if e <= lo or s >= hi:
            continue
        by_card[card].append((s, e))
        kernels += not name.startswith(COPY_PREFIXES)
        op_time[name] += (e - s) / 1e9
        # the runtime call that launched it (its thread and time); else the
        # op it is linked to (the innermost op open when it was launched)
        at = launches.get(corr) or (ops_by_corr.get(linked) if linked else None)
        if at is None:
            unlaunched += 1
            continue
        for rname in index:
            if launched_in(at, rname):
                range_ms[rname] += (e - s) / 1e6
                range_n[rname] += 1
    window_ns = hi - lo
    busy, gaps = {}, []
    for card, iv in by_card.items():
        b, g = _union(iv, lo, hi)
        busy[card] = b
        gaps += [(ge - gs, card, gs, ge) for gs, ge in g]
    threads = {tid: _Intervals(items) for tid, items in host.items()}
    named = []
    for length, card, gs, ge in sorted(gaps, reverse=True)[:10]:
        named.append([f"card {card}: {_host_at(threads, main, (gs + ge) // 2)}", length / 1e9])
    return {
        "window_s": window_ns / 1e9,
        "busy_s": {c: b / 1e9 for c, b in busy.items()},
        "kernels": kernels,
        "unattributed_launches": unlaunched,
        "range_ms": dict(range_ms),
        "range_ops": dict(range_n),
        "top_ops": sorted(([n, t] for n, t in op_time.items()), key=lambda x: -x[1])[:10],
        "idle_gaps": named,
    }


def _host_at(threads: dict, main: int, t: int) -> str:
    """What the host was doing at ``t``: the innermost op open on the
    pass's own thread, or where that thread had none open (it waited on
    other threads), the op most recently started on another thread that
    was open then, with the benchmark range it was in."""
    def label(chain):
        inner = chain[-1][2]
        outer = next((n for _, _, n in chain if n.startswith("gpubench.") and n != PASS), None)
        return inner if outer in (None, inner) else f"{inner} in {outer}"

    own = [c for c in threads[main].enclosing(t) if c[2] != PASS] if main in threads else []
    if own:
        return label(own)
    best = None
    for tid, iv in threads.items():
        if tid == main:
            continue
        chain = iv.enclosing(t)
        if chain and (best is None or chain[-1][0] > best[-1][0]):
            best = chain
    return f"another thread: {label(best)}" if best else "no host op open"


@contextlib.contextmanager
def traced_pass():
    """Profile the card(s) and the host's ops for the block."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield prof
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def roofline_share(ctx: dict, names) -> float | None:
    """A group of kernels' share of their roofline in the traced pass: the
    sum of the calls' least times (``gpubench/roofline.py``) over the
    device time of the operations launched inside the calls; None when the
    pass called none of them."""
    tr, ranges = ctx.get("trace"), ctx.get("ranges")
    if not tr or ranges is None:
        return None
    least, calls = ranges.least_seconds(names)
    device_ms = sum(tr["range_ms"].get(KERNEL + n, 0.0) for n in names)
    if not calls or device_ms <= 0:
        return None
    return 100.0 * least / (device_ms / 1e3)
