#!/usr/bin/env python3
"""Drive the PyTorch port (``aliby_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, in order; any failure exits non-zero:

1. build: nvcc compiles every kernel source under
   ``aliby_tpu_torch/kernels/csrc`` (one process per source, in parallel).
2. kernels: each kernel against its plain PyTorch version on the card, at
   the slice's shapes and a ragged one (stencils bit-equal; per-bin sums
   with exact counts, sums within rtol 1e-5, and bit-equal across runs).
3. slice: eight 256x256 five-channel Cell Painting fields, objects
   ``nuclei`` (channel 0, second channel 3) and ``cell`` (channel 3, second
   channel 0) through ``dispatch_segmenter("cellpose")`` as one batch of 16
   on one shared engine; then one 1080x1080 field. Every kernel must have
   launched; two runs must give identical labels; an f32 run on the card
   (TF32 off) must match an f32 run of the port on the CPU (equal object
   counts, matched IoU >= 0.99).
4. report: per-kernel times on the main path's own inputs (median of 21
   runs, CUDA events) beside the plain version, the bound and the library
   call; the ``kernels`` JSON line; the card's name and power limit; and,
   last, ``{"ok": true, "device": {...}}``.

Without CUDA, or outside the repository, it exits non-zero and prints no
result. Weights are the bundled checkpoint; inputs come from fixed seeds.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_OPS_S = 67e12  # H100 SXM, outside the tensor cores
REPS = 21


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps=REPS, warmup=2):
    """Median wall time of ``fn()`` on the card, in ms (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def matched_iou(a: np.ndarray, b: np.ndarray) -> float:
    """Mean over a's objects of the IoU with their best-overlapping b object."""
    a = a.astype(np.int64)
    b = b.astype(np.int64)
    na, nb = int(a.max()), int(b.max())
    if na == 0 or nb == 0:
        return 1.0 if na == nb else 0.0
    conf = np.zeros((na + 1, nb + 1), np.int64)
    np.add.at(conf, (a.ravel(), b.ravel()), 1)
    area_a, area_b = conf.sum(axis=1), conf.sum(axis=0)
    ious = []
    for i in range(1, na + 1):
        j = int(np.argmax(conf[i, 1:])) + 1
        union = area_a[i] + area_b[j] - conf[i, j]
        ious.append(conf[i, j] / union if union else 0.0)
    return float(np.mean(ious))


def random_successors(rng, B, H, W):
    """(B, H, W) int32 dcode of random unit flows (clipped in-grid, as
    follow_flows builds it) and the raster-index keys."""
    fy = rng.uniform(-1, 1, (B, H, W)).astype(np.float32)
    fx = rng.uniform(-1, 1, (B, H, W)).astype(np.float32)
    yi, xi = np.mgrid[0:H, 0:W]
    dy = np.clip(np.round(np.clip(yi + fy, 0, H - 1)).astype(np.int32) - yi, -1, 1)
    dx = np.clip(np.round(np.clip(xi + fx, 0, W - 1)).astype(np.int32) - xi, -1, 1)
    dcode = ((dy + 1) * 3 + (dx + 1)).astype(np.int32)
    key = np.broadcast_to((yi * W + xi).astype(np.int32), (B, H, W)).copy()
    return dcode, key


def tiled_labels(base: np.ndarray, B: int, H: int, W: int) -> np.ndarray:
    """(B, H, W) int32 label maps cut from tiled copies of ``base`` maps."""
    reps = (-(-H // base.shape[1]), -(-W // base.shape[2]))
    out = [np.tile(base[i % len(base)], reps)[:H, :W] for i in range(B)]
    return np.stack(out).astype(np.int32)


class Recorder:
    """Wraps a module attribute to keep the first arguments it is called with."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.args = None

    def __call__(self, *args, **kwargs):
        if self.args is None:
            self.args = (args, kwargs)
        return self.fn(*args, **kwargs)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def measure_kernels(recorders, launches) -> dict:
    """Time each kernel on the inputs the main path gave it (recorded), beside
    its plain version, the library call where one exists, and its bound."""
    from aliby_tpu_torch.ops import segsum, stencil

    d, k = recorders[0].args[0][:2]
    lab, src = recorders[1].args[0][:2]
    vals, bins, n_bins = recorders[2].args[0]
    dev = d.device
    out = {}

    def measure(name, kernel, plain, library, bytes_, ops, replaces, source, shape):
        out_k, out_p = kernel(), plain()
        torch.cuda.synchronize()
        err = (out_k.to(torch.float64) - out_p.to(torch.float64)).abs().max().item()
        t_bytes, t_ops = bytes_ / PEAK_BYTES_S * 1e3, ops / PEAK_F32_OPS_S * 1e3
        r = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err, "ms": cuda_ms(kernel),
            "plain_ms": cuda_ms(plain),
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": cuda_ms(library) if library is not None else None, "shape": list(shape),
        }
        out[name] = r
        log(f"[report] {name} {tuple(shape)}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
            f"library {r['library_ms']} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
            f"max abs err {err}, launches on the path {launches[name]}")

    B, H, W = d.shape
    px = B * H * W
    before = stencil.successor_prop.launches
    stencil.successor_prop(d, k)
    n_launch = stencil.successor_prop.launches - before
    rounds = 96 % 6 + 6 * (n_launch - (1 if 96 % 6 else 0))
    log(f"[report] successor_prop runs {rounds} rounds of 96 ({n_launch} launches) on {(B, H, W)}")
    measure("successor_prop", lambda: stencil.successor_prop(d, k),
            lambda: stencil.successor_prop_plain(d, k), None,
            bytes_=12 * px, ops=rounds * px,
            replaces="aliby_tpu/ops/pallas_stencil.py:115",
            source="aliby_tpu_torch/kernels/csrc/stencil.cu", shape=(B, H, W))
    B, H, W = lab.shape
    px = B * H * W
    measure("diffuse_heat", lambda: stencil.diffuse_heat(lab, src, 96),
            lambda: stencil.diffuse_heat_plain(lab, src, 96), None,
            bytes_=12 * px, ops=18 * 96 * px,
            replaces="aliby_tpu/ops/pallas_stencil.py:182",
            source="aliby_tpu_torch/kernels/csrc/stencil.cu", shape=(B, H, W))
    Bv, N, K = vals.shape
    flat = bins.reshape(Bv, -1).to(torch.int64)
    idx = torch.where((flat >= 0) & (flat < n_bins),
                      flat + torch.arange(Bv, device=dev)[:, None] * n_bins, Bv * n_bins).reshape(-1)
    flat_vals = vals.reshape(-1, K)
    acc = torch.zeros(Bv * n_bins + 1, K, device=dev)  # index_add returns a new tensor
    measure("binned_sum_cols_batched", lambda: segsum.binned_sum_cols_batched(vals, bins, n_bins),
            lambda: segsum.binned_sum_cols_batched_plain(vals, bins, n_bins),
            lambda: acc.index_add(0, idx, flat_vals),
            bytes_=Bv * N * (4 * K + bins.element_size()) + Bv * n_bins * K * 4, ops=Bv * N * K,
            replaces="aliby_tpu/ops/pallas_segsum.py:234",
            source="aliby_tpu_torch/kernels/csrc/segsum.cu", shape=(Bv, N, K))
    return out


def stage_breakdown(engine, images: np.ndarray, reps: int = 5) -> None:
    """Host time of each stage of one segmentation batch, serialised with
    synchronize() (median of ``reps``): the order of _segment_all and
    masks_from_flows."""
    from aliby_tpu_torch.extract.reductions import binned_sum_cols
    from aliby_tpu_torch.models import flows
    from aliby_tpu_torch.models.segment import _normalize_percentile

    x = torch.from_numpy(images).to(engine.device)
    times: dict[str, list] = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        return out

    for _ in range(reps):
        xn = stage("normalize", lambda: _normalize_percentile(x.permute(0, 2, 3, 1)))
        with torch.no_grad():
            pred = stage("unet", lambda: engine.model(xn))
        fl = flows._div(torch.stack([pred[..., 0], pred[..., 1]], dim=1), 5.0)
        fg = pred[..., 2] > engine.cellprob_threshold
        final = stage("follow_flows", lambda: flows.follow_flows(fl, fg, n_iter=engine.flow_iters))
        labels = stage("masks_from_sinks", lambda: flows.masks_from_sinks(
            final, fg, max_labels=engine.max_labels, drop_megamasks=False))
        mflows = stage("masks_to_flows (QC)", lambda: flows.masks_to_flows(
            labels, max_labels=engine.max_labels))
        B = labels.shape[0]
        lab_px = labels.reshape(B, -1)
        d = mflows - fl
        err = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]).reshape(B, -1)
        cols = torch.stack([torch.where(lab_px > 0, err, 0.0), (lab_px > 0).float()], dim=-1)
        stage("QC sums", lambda: binned_sum_cols(cols, lab_px.clamp(0, engine.max_labels),
                                                 engine.max_labels + 1))
        stage("fill_label_holes", lambda: flows.fill_label_holes(labels))
    med = {k: statistics.median(v) for k, v in times.items()}
    total = sum(med.values())
    log(f"[stages] batch {tuple(images.shape)}: " + ", ".join(
        f"{k} {v:.2f} ms ({100 * v / total:.0f}%)" for k, v in med.items()))


def device_share(fn) -> None:
    """Device-busy share of one run of ``fn`` and its top kernels, from
    torch.profiler (CUDA kernel self time over wall time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (the aten ops' rows repeat their kernels' time)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if busy_ms == 0:
        log("[profile] device time: not measured (the profiler saw no CUDA kernels)")
        return
    n_kernels = sum(e.count for e in events)
    log(f"[profile] one batch: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), idle {100 - 100 * busy_ms / wall_ms:.1f}%, "
        f"{n_kernels} kernels")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[profile]   {e.key[:70]}: {e.self_device_time_total / 1e3:.3f} ms in {e.count} calls")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from aliby_tpu_torch.extract import reductions
    from aliby_tpu_torch.kernels import _build
    from aliby_tpu_torch.models import flows
    from aliby_tpu_torch.models.segment import dispatch_segmenter, segment_grouped
    from aliby_tpu_torch.ops import segsum, stencil
    from aliby_tpu_torch.test_data import (
        cellpainting_fields,
        cellpainting_large_field,
        render_cells,
    )

    dev = torch.device("cuda")
    log("torch", torch.__version__, "cuda", torch.version.cuda, "device",
        torch.cuda.get_device_name(0), "count", torch.cuda.device_count())
    wrappers = {
        "successor_prop": stencil.successor_prop,
        "diffuse_heat": stencil.diffuse_heat,
        "binned_sum_cols_batched": segsum.binned_sum_cols_batched,
    }

    # ---------------------------------------------------------------- 1 build
    t0 = time.perf_counter()
    paths = _build.build()
    log(f"[build] {len(paths)} libraries in {time.perf_counter() - t0:.1f} s")
    for name, text in _build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {name}: {line.strip()}")

    # -------------------------------------------------------------- 2 kernels
    rng = np.random.default_rng(0)
    base = np.stack([render_cells(256, 24, rng)[2] for _ in range(4)])
    shapes = [(16, 256, 256), (2, 1080, 1080), (2, 1088, 1088), (3, 200, 312)]
    for B, H, W in shapes:
        d, k = random_successors(rng, B, H, W)
        dcode = torch.from_numpy(d).to(dev)
        key = torch.from_numpy(k).to(dev)
        for n_prop in (96, 17):
            got = stencil.successor_prop(dcode, key, n_prop=n_prop)
            want = stencil.successor_prop_plain(dcode, key, n_prop=n_prop)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"successor_prop != plain at {(B, H, W)}, n_prop {n_prop}")
        labels = torch.from_numpy(tiled_labels(base, B, H, W)).to(dev)
        src = flows.label_median_centers(labels, 512).to(torch.float32)
        got = stencil.diffuse_heat(labels, src, 96)
        want = stencil.diffuse_heat_plain(labels, src, 96)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            err = (got - want).abs().max().item()
            raise AssertionError(f"diffuse_heat != plain at {(B, H, W)} (max abs {err})")
        n_bins = 257
        bins = torch.from_numpy(rng.integers(-2, n_bins + 3, (B, H * W)).astype(np.int32)).to(dev)
        vals = torch.stack([
            torch.from_numpy(rng.exponential(1.0, (B, H * W)).astype(np.float32)).to(dev),
            torch.ones(B, H * W, device=dev),
            torch.from_numpy((rng.random((B, H * W)) < 1e-3).astype(np.float32)).to(dev),
        ], dim=-1)
        got = segsum.binned_sum_cols_batched(vals, bins, n_bins)
        again = segsum.binned_sum_cols_batched(vals, bins, n_bins)
        want = segsum.binned_sum_cols_batched_plain(vals, bins, n_bins)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"binned_sum_cols_batched differs between runs at {(B, H, W)}")
        if not torch.equal(got[..., 1:], want[..., 1:]):
            raise AssertionError(f"binned_sum_cols_batched counts != plain at {(B, H, W)}")
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
        log(f"[kernels] {(B, H, W)}: successor_prop, diffuse_heat bit-equal; "
            f"binned_sum_cols_batched counts exact, sums max abs err "
            f"{(got - want).abs().max().item():.3g}, deterministic")

    # ---------------------------------------------------------------- 3 slice
    pixels = np.concatenate(cellpainting_fields(8, 256, seed=7))  # (8, 5, 1, 256, 256)
    nuclei = dispatch_segmenter("cellpose", 0, second_channel=3)
    cell = dispatch_segmenter("cellpose", 3, second_channel=0)
    if nuclei.engine is not cell.engine:
        raise AssertionError("nuclei and cell must share one engine")
    segment_grouped([nuclei, cell], pixels)  # warm-up (cuDNN plans, kernel loads)
    torch.cuda.synchronize()

    recorders = [Recorder(flows, "successor_prop"), Recorder(flows, "diffuse_heat"),
                 Recorder(reductions, "binned_sum_cols_batched")]
    for w in wrappers.values():
        w.launches = 0
    with contextlib.ExitStack() as stack:
        for r in recorders:
            stack.enter_context(r)
        t0 = time.perf_counter()
        run1 = segment_grouped([nuclei, cell], pixels)
        torch.cuda.synchronize()
        t_run1 = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    log(f"[slice] 8 fields x 2 objects (one batch of 16): {t_run1 * 1e3:.1f} ms; "
        f"launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        run2 = segment_grouped([nuclei, cell], pixels)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    for obj, (a, b) in enumerate(zip(run1, run2)):
        for f, (x, y) in enumerate(zip(a, b)):
            if not np.array_equal(x, y):
                raise AssertionError(f"labels differ between runs (object {obj}, field {f})")
    counts = [[int(m.max()) for m in masks] for masks in run1]
    for masks in run1:
        for m in masks:
            if m.shape != (256, 256) or m.dtype != np.uint16 or m.max() == 0:
                raise AssertionError(f"bad mask: shape {m.shape}, dtype {m.dtype}, max {m.max()}")
    t_med = statistics.median(times)
    fields_s = 8 / t_med
    log(f"[slice] objects per field: nuclei {counts[0]}, cell {counts[1]}")
    log(f"[slice] steady state: {t_med * 1e3:.1f} ms per batch = {fields_s:.2f} fields/s "
        f"({16 / t_med:.2f} images/s); labels identical across runs")

    big = cellpainting_large_field(1080, seed=11)  # bench density, ~400 cells
    for w in wrappers.values():
        w.launches = 0
    big_recorders = [Recorder(flows, "successor_prop"), Recorder(flows, "diffuse_heat"),
                     Recorder(reductions, "binned_sum_cols_batched")]
    with contextlib.ExitStack() as stack:
        for r in big_recorders:
            stack.enter_context(r)
        t0 = time.perf_counter()
        big_masks = segment_grouped([nuclei, cell], big)
        torch.cuda.synchronize()
        t_big = time.perf_counter() - t0
    big_launches = {name: w.launches for name, w in wrappers.items()}
    for name, n in big_launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the 1080x1080 field")
    big_counts = [int(m[0].max()) for m in big_masks]
    if any(m[0].shape != (1080, 1080) or m[0].max() == 0 for m in big_masks):
        raise AssertionError(f"bad 1080x1080 masks: shapes {[m[0].shape for m in big_masks]}, "
                             f"objects {big_counts}")
    log(f"[slice] one 1080x1080 field x 2 objects: {t_big * 1e3:.1f} ms (first call at this "
        f"size); objects nuclei {big_counts[0]}, cell {big_counts[1]}; launches {big_launches}")

    stage_breakdown(nuclei.engine, np.concatenate([nuclei.images(pixels), cell.images(pixels)]))
    device_share(lambda: segment_grouped([nuclei, cell], pixels))

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("[slice] f32 comparison: torch.backends.cudnn.allow_tf32 = False, "
        "torch.backends.cuda.matmul.allow_tf32 = False")
    f32 = {"model_kwargs": {"dtype": torch.float32}}
    gpu = segment_grouped([dispatch_segmenter("cellpose", 0, second_channel=3, **f32),
                           dispatch_segmenter("cellpose", 3, second_channel=0, **f32)], pixels)
    cpu = segment_grouped([dispatch_segmenter("cellpose", 0, second_channel=3, device="cpu", **f32),
                           dispatch_segmenter("cellpose", 3, second_channel=0, device="cpu", **f32)],
                          pixels)
    worst, n_equal = 1.0, 0
    for obj, (a, b) in enumerate(zip(gpu, cpu)):
        for f, (x, y) in enumerate(zip(a, b)):
            if x.max() != y.max():
                raise AssertionError(f"GPU/CPU object counts differ (object {obj}, field {f}): "
                                     f"{x.max()} vs {y.max()}")
            iou = min(matched_iou(x, y), matched_iou(y, x))
            worst = min(worst, iou)
            n_equal += int(np.array_equal(x, y))
            if iou < 0.99:
                raise AssertionError(f"GPU/CPU matched IoU {iou:.4f} < 0.99 (object {obj}, field {f})")
    log(f"[slice] f32 GPU vs CPU: object counts equal, worst matched IoU {worst:.6f}, "
        f"{n_equal}/16 label maps bit-equal")

    # --------------------------------------------------------------- 4 report
    main_path = measure_kernels(recorders, launches)
    rows = [main_path[name] for name in wrappers]
    log("[report] the same, on the 1080x1080 field's inputs:")
    measure_kernels(big_recorders, big_launches)

    log(json.dumps({"slice": {"fields_per_s": fields_s, "batch_ms": t_med * 1e3,
                              "objects": counts, "field_1080_ms": t_big * 1e3}}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi.splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
