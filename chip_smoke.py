#!/usr/bin/env python3
"""Drive the PyTorch port (``aliby_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, in order; any failure exits non-zero:

1. build: nvcc compiles every kernel source under
   ``aliby_tpu_torch/kernels/csrc`` (one process per source, in parallel).
2. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes and a ragged one: stencils, per-bin min/max and
   table lookup bit-equal (NaN positions equal); the stencils at n_prop 0,
   1, 5, 17, 96 and 97 (clipped fields and unclipped ones with dcodes
   outside [0, 9)) and n_iter 1, 8, 9, 10 and 96 (around the diffusion
   kernel's 9 rounds a launch; a label touching all four borders; sources
   of +inf); per-bin sums (K = 3 and
   K = 17) with exact counts, sums within rtol 1e-5 and the summation bound
   of the plain version, and bit-equal (NaN positions equal) to the
   kernel's order taken on the CPU (``segsum.binned_sum_cols_batched_chunked``)
   and across runs; the unbatched ``segment_sum_matmul`` at (16 x 65,536,
   16) -> 256 labels and a ragged N (integer-valued columns exact, the rest
   within the worst-case f32 summation bound, bit-equal to
   ``segment_sum_matmul_chunked`` on the CPU and across runs); two
   adversarial sums (every pixel in one bin; every pixel in its own bin of
   66,049), bit-equal to the CPU's; the column grouping of
   ``reductions.binned_sum_cols`` at K = 367 against the plain sum and, bit
   for bit, against the same grouping on the CPU in the kernel's order, with
   a non-finite value poisoning all 367 columns of its bin. Per-bin min/max
   and the lookup also on adversarial inputs: label images (objects on a
   background, the bbox's coordinate columns among them), every pixel in one
   bin, one pixel per bin, a ragged N (odd, N x K not a multiple of 4, one
   image and three), the limits n_bins x K = 4,096 and L x K = 12,288, every
   lookup K from 1 to 8 and 13, +-inf, NaN and signed zeros: the lookup the
   same bits as plain, min/max equal with NaN positions equal, and -0.0 below
   +0.0 (a bin holding both: min -0.0, max +0.0).
3. slice 1 (segmentation): eight 256x256 five-channel Cell Painting fields,
   objects ``nuclei`` (channel 0, second channel 3) and ``cell`` (channel 3,
   second channel 0) through ``dispatch_segmenter("cellpose")`` as one batch
   of 16 on one shared engine; then one 1080x1080 field. Its three kernels
   must have launched; two runs must give identical labels; an f32 run on
   the card (TF32 off) must match an f32 run of the port on the CPU (equal
   object counts, matched IoU >= 0.99); the main path's bf16 labels on the
   card must match f32 labels on the card, on the eight fields and the
   1080x1080 one (object counts within max(1, 5%), matched IoU >= 0.90).
   slice 2 (the fused step): the example-01 pipeline
   (``build_pipeline_steps`` -> ``try_compile`` -> ``.fused``) on the same
   eight fields. All five kernels must have launched; labels must equal
   slice 1's ``segment_grouped`` on the same pixels; labels and the feature
   block must be identical across two runs; the column set must be the
   golden example-01 anchor; the f32 feature block on the card must match
   the port's on the CPU, which takes its sums in the kernel's order, at
   the parity tests' tolerances (``aliby_tpu_torch.extract.tolerances``:
   no value beyond them but in costes' threshold scan, at most 5% there);
   the 1080x1080 field must take the sticky wide pass (cap 256, uint8 kept).
   slice 3 (the default bank): ``build_pipeline_steps`` with its default
   features (radial_zernikes, intensity with edges, feret, texture,
   radial_distribution, zernike; sizeshape; the coloc tree) on all five
   channels, through the same entry points and held to the same checks:
   kernels 1-5 launched, labels equal to ``segment_grouped``'s, identical
   runs, the golden default-bank column set, the wide pass, f32 on the card
   against the CPU; the integer rasters behind the new families (gray
   levels, rings, wedges, centres) and the minimum enclosing circles have
   the same bits on the card and the CPU. ``segment_sum_matmul`` has no caller on any path, here as
   in the JAX package: phases 2 and 4 run it.
4. report: per-kernel times on the default-bank step's own inputs (median of 21
   runs, CUDA events, in turns with the plain version and the library call)
   beside theirs and the bound, each kernel's output held to the plain version's on those inputs
   as in phase 2 (the sums also bit-equal to the kernel's order on the CPU
   and across runs), the costes histogram of the 1080x1080 field's wide
   pass (66,049 bins), and ``segment_sum_matmul`` at phase 2's shape; each
   main-path sum no slower than ``index_add_`` in the same call
   (``segment_sum_matmul``'s ratio reported), and the device time per
   launch of one sum call (the costes histograms, ``segment_sum_matmul``);
   for the stencils, launches a call (at most 8 and 13 at 96 rounds),
   device time per launch, the wrapper's host time and the time a call in
   a run, beside a bound counted from this run's data (``diffuse_heat``:
   its least f32 instructions at the issue rate, an FMA one);
   for per-bin min/max and the lookup at both main-path shapes, the time per
   call (one call, and within a run of 50 calls) beside its device time per
   launch and the wrapper's host time, the
   ratio to the library call (min/max no slower than ``scatter_reduce``),
   and the widths of every call in one default-bank step;
   each fused
   step's fields/s, stage breakdown and peak memory, the default bank's
   device idle share; the ``kernels`` JSON line (six kernels, launches counted
   over one default-bank step, and a seventh row: the trackers'
   intersection count, phase 5's; later phases add theirs); the card's name and power limit;
   and, last, ``{"ok": true, "device": {...}}``.
5. runner (slice 4): 2 positions x 3 timepoints x 5 channels x 1 z x
   1080x1080 uint16 (``test_data.cellpainting_movie``: cells drift, a few
   appear and vanish) written to a zlib zarr directory store
   (``io.zarrlite``), found by ``DatasetZarr``; the default-bank pipeline
   with a stitch tracker per object (max_labels 256, IoU 0.25), mono tile,
   compiled, the segment and tracker steps saved, through (a) the per-tp
   path (``run_pipeline_return_state``, ``movie: False``), (b) the movie
   path (chunks of 2: a tracker carry and a ragged one-tp tail) and (c)
   ``run_positions_mesh_states`` over both positions (chunks of 2). No
   pyarrow is needed: profiles are compared as ``profile_columns``. Checks:
   kernels 1-5 launched in each run; the fused step's sticky wide pass;
   profile columns (NaN equal), tracker states and every saved ``.npz``
   identical across (a), (b) and (c); the card's tracks bit-equal to the
   CPU's ``stitch_movie`` on the card's own labels; each tp's largest global
   label at least frame 0's object count; every chunk's ``track_chunk``
   under ``torch.cuda.set_sync_debug_mode("error")``. Prints field-tps/s
   and peak memory of each run, the ``ALIBY_MESH_TIMING`` split, the device
   idle share of a short window of the per-tp and mesh paths, the time of
   one ``stitch_movie`` chunk and one ``stitch_pair`` batch, and the
   intersection count's kernel row (phase 4's measurements, at the mesh's
   (2, 1,166,400, 1) -> 66,049 bins).
6. the yeast path (slice 5, example 03): one position x 5 tps x 3 channels
   x 3 z of 1024^2 uint16 (``test_data.yeast_trap_movie``: 36 ALCATRAS-like
   traps in bright field, yeast cells in them, some budding, the stage
   drifting ~1 px a tp) in a zlib zarr store. (a) Trap detection at tile
   size 117 on the card and on the CPU: the same count, every centre within
   1 px of the CPU's, the card's time. (b) The BABY pipeline
   (``pipe_builder_baby``: trap tiles, drift tracking, the threshold base at
   scale 0.6, 3 layers; the BABY default tree plus every cellfuns, trap and
   localisation metric and a channel ratio) through the state path (no
   parquet): kernels 3-5 launched; two card runs identical (layered masks,
   tracking/lineage columns, profile columns, NaN equal); trap centres,
   drifts, masks and tracking/lineage equal to the CPU's over all 5 tps (a
   segment-only CPU run) and profiles of tps 0-1 within
   ``extract.tolerances`` (a CPU run with extraction, its sums in the
   kernel's order); ms a tp, the stage split, peak memory and the device
   idle share of one tp. (c) The cellpose kind on the trap tiles through the
   compiled runner, 3 tps, a stitch tracker: kernels 1-5 launched with B =
   traps, the card's tracks equal to the CPU's ``stitch_movie`` on the
   card's labels. (d) Kernels 3-5 at the overlap path's virtual-tile shape
   (traps x 3 layers of 117^2, empty layers among them), recorded in (b):
   held to their plain versions (the sums to the kernel's order on the
   CPU) and timed, three more rows of the ``kernels`` line.
7. the model zoo and the model server (slice 6): (a) a seeded Cellpose
   checkpoint at the cyto width (``nbase`` (2, 32, 64, 128, 256),
   ``test_data.cpnet_state_dict``, written with ``torch.save``) as the
   default bank's ``pretrained_path``, through ``run_positions_mesh`` on 1
   position x 3 tps of 1080^2 (``test_data.cellpainting_movie``): with the
   flow-error QC on (the default; kernels 1-5 launched) and off
   (``flow_threshold=None``: random weights leave few objects through the
   QC; every field must keep labels); per-tp == movie == mesh == a second
   mesh run (labels, profile columns, saves); the CPnet forward a 1080^2
   image in f32 (cuDNN TF32 off inside, the global flag unchanged) and
   bf16; card vs CPU labels on a 256^2 crop (QC on and off: bit-equal, or
   equal counts and matched IoU >= 0.99) and the f32 forward within 2e-4 of
   max(1, its scale). (b) Example 02: 4 positions x 5 channels x 1080^2 in a
   zlib zarr store, crop tiles of 64, ``embed_cells`` (style, dim 64)
   through the state path: two card runs the same bits, ``X_*`` columns
   against the CPU's by the bf16 embedding rule (max |diff| <= 2e-3, mean
   <= 2e-4), ms a position. (c) A
   ``ModelServer`` on ``ipc://`` in a thread, on the card; a client
   pipeline of ``nahual_cellpose``, ``nahual_spotiflow``, ``nahual_embed``
   and the ``nahual_trackastra`` global step over the 3 tps: kernels 1-3
   launched inside the server; masks, embeddings and tracks columns equal
   to the same models in process on the card; round trip and bytes a
   request. (d) ``detect_spots`` + ``paint_spots`` on 16 frames of 1080^2:
   the card's coordinates, radii and labels equal to the CPU's; ms a frame.
8. training (slice 7): the flagship U-Net at full width (32, 64, 128, 256),
   bf16, batches of 8 synthetic fields at 128^2 (``models.training.
   synthetic_batch``: the host renders, the targets come from one
   ``masks_to_flows`` call a batch on the card), AdamW with optax's defaults
   on a cosine schedule (alpha 0.05), as ``scripts/torch_train_flagship.py``
   runs it. (a) 30 steps from ``init_params(seed=0)`` at peak 2e-3, every
   launch counter set to 0 before: the mean loss of the last 5 steps below
   that of the first 5, 12 ``diffuse_heat`` launches a step (none of the
   other kernels), steps/s end to end and peak memory. (b) 20 steps from the
   bundled weights (the port's ``load_params``) at peak 5e-4, written with
   ``save_params``: ``dispatch_segmenter("cellpose", pretrained_path=...)``
   on the card gives the U-Net output bits and the labels of the f16-rounded
   parameters in memory; ``test_trained_cellpose_quality``'s gate (objects
   within 3, matched IoU > 0.85) reported for both checkpoints, asserted on
   the bundled one. (c) The targets' ``diffuse_heat`` call (8 x 128^2, 96
   rounds) held bit-equal to its plain version and timed beside its bound,
   a row of the ``kernels`` line. (d) The training script's length, held
   to the JAX loop: ``scripts/torch_train_parity.py``'s resumed run (seed
   0, 400 steps from the bundled weights at peak 5e-4) in f32 on the card
   (TF32 off, cuDNN deterministic, as ``make_train_step`` sets them), then
   the candidate's held-out IoU (``models.training.heldout_sets``, the
   training scripts' fixed renders, 6 a set) through ``CellposeTorch`` on
   the card in f32 (TF32 off): each set within max(0.005, the chaos floor) of the JAX
   loop's own result through JAX's f32 engine on the CPU for the same seed
   and N (constants below, with the command and commit that printed them;
   the bf16 engine's IoU is printed beside JAX's, not held: the
   frameworks' bf16 forwards round apart; the bf16 U-Net's flow error
   against ``models.unet.forward_f64`` is held within 1.05x that of JAX's
   U-Net compiled with every bf16 rounding); the kernels' launches
   during the training and during the evaluation (``diffuse_heat`` in the
   targets; ``successor_prop``, ``diffuse_heat`` and the sums in the
   evaluation's dynamics and flow-error QC), steps/s. (e) Two runs of 5
   steps from one seed, in f32 and in bf16, give the same losses and
   parameter bits; one f32 step on the card (TF32 off) against the CPU's:
   the loss within ``LOSS_RTOL`` and each gradient within the card's limits
   of ``extract.tolerances.gradient_excess``; a step under
   ``torch.cuda.set_sync_debug_mode("error")``. (f) ms a step (CUDA events)
   in bf16 and f32, split into forward-backward and optimizer, ms of the
   targets on the card, host render ms a batch, the device idle share of 3
   steps, and a ``utils.profiling.trace`` of 2 steps whose ``span``
   names are found in the profile.
9. example 01 from a TIFF plate (slice 8): (a) g++ builds the port's native
   TIFF decoder (``aliby_tpu_torch.native.build``, its own copy of the
   source, into ``build/aliby_tpu_torch/``; the deflate case is compiled
   out where the host has no ``<zlib.h>``, and the plate is then written
   uncompressed); (b) a plate of 2 wells x 2 fields x 5 channels of
   1080^2 uint16 (``cellpainting_large_field``, seeds 21-24), a file a
   plane named by example 01's convention, written by this script's
   baseline-TIFF writer (``write_tiff``: strips of 64 to 256 rows, every
   other file deflate, every third big-endian); (c) every plane decoded
   by ``tiff_decode`` and ``tiff_decode_batch`` bit-equal to the array
   written, ms a plane of each; (d) ``DatasetDir`` finds 4 positions;
   example 01's pipeline (intensity and sizeshape, the cellpose kind with
   the bundled weights, compiled) through ``run_positions_mesh_states``
   and ``run_pipeline_return_state`` a position: kernels 1-5 launched,
   every read of the data plane a native decode, mesh == per position
   (profile columns, NaN equal), the golden example-01 column set; (e)
   position 0's pixels in a zlib zarr store give its profile bit for bit,
   (f) and in a JPEG-XL one where the host has libjxl (else "jxl: libjxl
   not found on this host"); neither imageio nor PIL imported; (g) fields/s
   of each path, peak memory, the device idle share of one mesh call, and
   kernels 1-5 timed at the mesh call's (8, 1080, 1080) shapes, rows
   "... (TIFF plate)" of the ``kernels`` line.
10. several devices (slice 9): (a) example 04's path
   (``examples/04_mesh_parallel_plate.py``: ``crop_cellpainting_256``
   through its pipeline, via ``run_positions_mesh_states``) and a tracked
   plate (3 positions x 4 tps of 512^2 in a zlib zarr store, a stitch
   tracker per object, chunks of 2, shards of 2 + 1 positions, the last
   position alone past the fused step's initial width of 64) on
   ``make_mesh(devices=["cuda:0"] * 2)`` (two shards on one card, each in
   its own thread and stream) and, with several cards, on ``make_mesh()``:
   profiles, labels, tracks and saves bit-equal to dp = 1, both shards
   widened at once, each shard's launches of kernels 1-5 printed and equal
   to a dp = 1 run's (one call a chunk each); kernels 1-5 at the tracked
   plate's two shard shapes (recorded per shard stream in its dp = 2 run)
   launched from two threads at once, each on a stream of its own, and held
   to plain, then timed as rows "... (dp shards)" of the ``kernels`` line
   with that run's launches; (b) the sharded train step at
   the flagship widths (32, 64, 128, 256), 8 x 128^2 f32 with TF32 off, in
   4 gloo ranks on cuda:0 (dp 2 x sp 2, ``parallel.dryrun.spawn_ranks``),
   3 steps against the one-process ``make_train_step`` on the same card:
   losses within ``LOSS_RTOL``, the first batch's global gradient by
   ``gradient_excess`` (``GRAD_RTOL``), the parameters' updates by ``extract.tolerances.
   update_excess`` (L2, ``UPDATE_RTOL``), the same bits on every rank,
   ``diffuse_heat`` launched in every rank; (c) the sp forward of the
   bundled flagship on 2 fields of 1080^2 in the same ranks (an sp pair a
   field, 544 + 536 rows) in f32 (rtol and atol 1e-4) and bf16 (the flow
   rule of ``extract.tolerances``) against the one-process forward. Prints
   each part's seconds, ms a step and a forward beside one process's.
   Each phase prints its seconds. ``python3 chip_smoke.py --phase 8`` (or
   ``--phase 10``) builds the kernels and runs that phase alone (no result
   line).

Without CUDA, or outside the repository, it exits non-zero and prints no
result. Weights are the bundled checkpoint; inputs come from fixed seeds.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_OPS_S = 67e12  # H100 SXM, outside the tensor cores (an FMA counts two)
PEAK_F32_INSTR_S = PEAK_F32_OPS_S / 2  # f32 instructions a second, an FMA one
# diffuse_heat's least f32 instructions per foreground pixel and round, on
# data like the main path's (non-negative heat and sources): one add for
# each same-label neighbour (counted from the labels), one for a non-zero
# source, and the correctly rounded division by 9: a multiply and two FMAs
# (stencil.cu div9_nonneg; scripts/torch_stencil_split.py --sass counts the
# kernel's); a background pixel needs none
DIFFUSE_DIV_INSTR = 3
STENCIL_ROUNDS = 96  # the main path's n_prop and n_iter
SUCC_MAX_LAUNCHES = 8  # launches a call at 96 rounds, at most
DIFFUSE_MAX_LAUNCHES = 13
STENCIL_PROPS = (0, 1, 5, 17, 96, 97)
STENCIL_ITERS = (1, 8, 9, 10, 96)  # around the kernel's 9 rounds a launch
BF16_COUNT_SHARE = 0.05  # bf16 vs f32 card labels: object counts within max(1, 5%)
BF16_MIN_IOU = 0.90  # and worst matched IoU (both ways) at least this
REPS = 21
F32_EPS = 2.0 ** -23
SLICE1_KERNELS = ("successor_prop", "diffuse_heat", "binned_sum_cols_batched")
REPLACES = {
    "successor_prop": "aliby_tpu/ops/pallas_stencil.py:115",
    "diffuse_heat": "aliby_tpu/ops/pallas_stencil.py:182",
    "binned_sum_cols_batched": "aliby_tpu/ops/pallas_segsum.py:234",
    "binned_minmax_batched": "aliby_tpu/ops/pallas_segsum.py:251",
    "table_lookup_batched": "aliby_tpu/ops/pallas_segsum.py:302",
    "segment_sum_matmul": "aliby_tpu/ops/pallas_segsum.py:64",
    "binned_sum_cols_batched (stitch_pair intersection count)":
        "aliby_tpu/ops/pallas_segsum.py:234",
    "binned_sum_cols_batched (BABY virtual tiles)": "aliby_tpu/ops/pallas_segsum.py:234",
    "binned_minmax_batched (BABY virtual tiles)": "aliby_tpu/ops/pallas_segsum.py:251",
    "table_lookup_batched (BABY virtual tiles)": "aliby_tpu/ops/pallas_segsum.py:302",
    "successor_prop (CPnet mesh)": "aliby_tpu/ops/pallas_stencil.py:115",
    "diffuse_heat (CPnet mesh)": "aliby_tpu/ops/pallas_stencil.py:182",
    "binned_sum_cols_batched (CPnet mesh)": "aliby_tpu/ops/pallas_segsum.py:234",
    "binned_minmax_batched (CPnet mesh)": "aliby_tpu/ops/pallas_segsum.py:251",
    "table_lookup_batched (CPnet mesh)": "aliby_tpu/ops/pallas_segsum.py:302",
    "diffuse_heat (training targets)": "aliby_tpu/ops/pallas_stencil.py:182",
    "successor_prop (TIFF plate)": "aliby_tpu/ops/pallas_stencil.py:115",
    "diffuse_heat (TIFF plate)": "aliby_tpu/ops/pallas_stencil.py:182",
    "binned_sum_cols_batched (TIFF plate)": "aliby_tpu/ops/pallas_segsum.py:234",
    "binned_minmax_batched (TIFF plate)": "aliby_tpu/ops/pallas_segsum.py:251",
    "table_lookup_batched (TIFF plate)": "aliby_tpu/ops/pallas_segsum.py:302",
    "successor_prop (dp shards)": "aliby_tpu/ops/pallas_stencil.py:115",
    "diffuse_heat (dp shards)": "aliby_tpu/ops/pallas_stencil.py:182",
    "binned_sum_cols_batched (dp shards)": "aliby_tpu/ops/pallas_segsum.py:234",
    "binned_minmax_batched (dp shards)": "aliby_tpu/ops/pallas_segsum.py:251",
    "table_lookup_batched (dp shards)": "aliby_tpu/ops/pallas_segsum.py:302",
}
SEGMENT_SUM_SHAPE = (16 * 65536, 16, 256)  # N, K, max_labels
DEFAULT_BANK = dict(channels_to_segment={"nuclei": 0, "cell": 3},
                    channels_to_extract=[0, 1, 2, 3, 4])
EXAMPLE01 = dict(DEFAULT_BANK, features_to_extract=("intensity", "sizeshape"),
                 cp_measure_feature_kwargs={"intensity": {"edge_measurements": False}})
# name -> build_pipeline_steps arguments, rows of the (mono, coloc) feature blocks, golden column file
FUSED_PATHS = {
    "example-01": (EXAMPLE01, (158, 80), "example01_columns.txt"),
    "default bank": (DEFAULT_BANK, (685, 80), "default_bank_columns.txt"),
}


def log(*a):
    print(*a, flush=True)


def sync():
    torch.cuda.synchronize()


def cuda_ms_turns(fns, reps=REPS, warmup=2) -> list:
    """Median wall time on the card of each of ``fns``, in ms (CUDA events),
    the functions timed in turns, so that the host's drift during the
    measurement falls on all of them alike."""
    for fn in fns:
        for _ in range(warmup):
            fn()
    times = [[] for _ in fns]
    for _ in range(reps):
        for t, fn in zip(times, fns):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            sync()
            t.append(start.elapsed_time(end))
    return [statistics.median(t) for t in times]


def cuda_ms(fn, reps=REPS, warmup=2):
    """Median wall time of ``fn()`` on the card, in ms (CUDA events)."""
    return cuda_ms_turns([fn], reps, warmup)[0]


def host_ms(fn, reps=5):
    """Median host time of ``fn()`` ending in a synchronize, in ms."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def equal_nan(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal values and equal NaN positions."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """The same bits at every position, NaN positions equal (any payload)."""
    a, b = a.cpu(), b.cpu()
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a[~nan].view(torch.int32), b[~nan].view(torch.int32))


def check_kernel_order(kernel, on_cpu, what: str) -> None:
    """A sum kernel's output (two runs of ``kernel()``) has the bits of
    ``on_cpu()``, its order taken on the CPU, and the same bits twice."""
    got, again = kernel(), kernel()
    sync()
    want = on_cpu()
    if not same_bits(got, again):
        raise AssertionError(f"{what}: two runs differ")
    if not same_bits(got, want):
        g, w = got.cpu(), want
        n = int((~((g == w) | (torch.isnan(g) & torch.isnan(w)))).sum())
        raise AssertionError(f"{what}: != the kernel's order on the CPU ({n} sums differ)")


def check_sum_order(vals, bins, n_bins, what: str) -> None:
    from aliby_tpu_torch.ops import segsum

    check_kernel_order(
        lambda: segsum.binned_sum_cols_batched(vals, bins, n_bins),
        lambda: segsum.binned_sum_cols_batched_chunked(vals.cpu(), bins.cpu(), n_bins),
        f"binned_sum_cols_batched {what}")


def max_abs_err(got, want) -> float:
    """Largest |got - want|; equal entries (the same inf, both NaN) count 0
    and a NaN against a number counts inf."""
    if isinstance(got, (tuple, list)):
        return max(max_abs_err(g, w) for g, w in zip(got, want))
    g, w = got.to(torch.float64), want.to(torch.float64)
    same = (g == w) | (torch.isnan(g) & torch.isnan(w))
    d = torch.where(same, torch.zeros((), dtype=g.dtype, device=g.device), (g - w).abs())
    return float(torch.nan_to_num(d, nan=float("inf")).max()) if d.numel() else 0.0


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
    """Wraps a module attribute to keep the arguments of the first call
    that ``want(*args)`` accepts (by default the first call). Several
    recorders may wrap one attribute: each passes the call on to the one
    entered before it."""

    def __init__(self, module, name, want=None):
        self.module, self.name = module, name
        self.want = want or (lambda *a: True)
        self.fn = None
        self.args = None

    def __call__(self, *args, **kwargs):
        if self.args is None and self.want(*args):
            self.args = args
        return self.fn(*args, **kwargs)

    def __enter__(self):
        self.fn = getattr(self.module, self.name)
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


class Tally(Recorder):
    """A Recorder that also counts its calls by ``describe(*args)``."""

    def __init__(self, module, name, describe):
        super().__init__(module, name)
        self.describe = describe
        self.counts = collections.Counter()

    def __call__(self, *args, **kwargs):
        self.counts[self.describe(*args)] += 1
        return super().__call__(*args, **kwargs)


def recording(recorders):
    stack = contextlib.ExitStack()
    for r in recorders:
        stack.enter_context(r)
    return stack


def stencil_checks(rng, dev, base, B, H, W) -> None:
    """Phase 2, the stencils at one shape: ``successor_prop`` at every
    ``STENCIL_PROPS`` on a clipped field (as follow_flows builds it) and on
    an unclipped one with dcodes outside [0, 9); ``diffuse_heat`` at every
    ``STENCIL_ITERS`` on tiled label maps whose first image has a label
    touching all four borders, and with a source holding +inf. All
    ``torch.equal`` to plain (the +inf case: the same bits, NaN positions
    equal)."""
    from aliby_tpu_torch.models import flows
    from aliby_tpu_torch.ops import stencil

    d, k = random_successors(rng, B, H, W)
    fields = {"clipped": (d, k),
              "unclipped": (rng.integers(-3, 12, (B, H, W)).astype(np.int32),
                            rng.integers(1, 2**31 - 1, (B, H, W)).astype(np.int32))}
    for what, (d, k) in fields.items():
        dcode, key = torch.from_numpy(d).to(dev), torch.from_numpy(k).to(dev)
        for n_prop in STENCIL_PROPS:
            got = stencil.successor_prop(dcode, key, n_prop=n_prop)
            want = stencil.successor_prop_plain(dcode, key, n_prop=n_prop)
            sync()
            if not torch.equal(got, want):
                raise AssertionError(f"successor_prop != plain at {(B, H, W)}, {what} field, "
                                     f"n_prop {n_prop}")
    lab = tiled_labels(base, B, H, W)
    ring = int(lab.max()) + 1
    lab[0, 0, :], lab[0, -1, :], lab[0, :, 0], lab[0, :, -1] = ring, ring, ring, ring
    labels = torch.from_numpy(lab).to(dev)
    src = flows.label_median_centers(labels, 512).to(torch.float32)
    for n_iter in STENCIL_ITERS:
        got = stencil.diffuse_heat(labels, src, n_iter)
        want = stencil.diffuse_heat_plain(labels, src, n_iter)
        sync()
        if not torch.equal(got, want):
            err = (got - want).abs().max().item()
            raise AssertionError(f"diffuse_heat != plain at {(B, H, W)}, n_iter {n_iter} "
                                 f"(max abs {err})")
    # +inf on a foreground pixel (inf spreads through its label) and on the
    # background pixel above or left of the first foreground pixel (inf * 0:
    # NaN in the label beside it)
    ys, xs = np.nonzero(lab[-1] > 0)
    src[-1, ys[len(ys) // 2], xs[len(xs) // 2]] = float("inf")
    src[-1, max(ys[0] - 1, 0), xs[0] - (ys[0] == 0)] = float("inf")
    for n_iter in (9, STENCIL_ROUNDS):
        got = stencil.diffuse_heat(labels, src, n_iter)
        want = stencil.diffuse_heat_plain(labels, src, n_iter)
        if not same_bits(got, want) or not torch.isnan(want).any():
            raise AssertionError(f"diffuse_heat != plain at {(B, H, W)}, n_iter {n_iter}, with "
                                 f"a source of +inf")
    log(f"[kernels] {(B, H, W)}: successor_prop equal to plain at n_prop {STENCIL_PROPS} "
        f"(clipped and unclipped fields); diffuse_heat at n_iter {STENCIL_ITERS} (a label "
        f"touching all four borders) and with sources of +inf (NaN positions equal)")


def kernel_checks(rng, dev) -> None:
    """Phase 2: every kernel against its plain version on the card."""
    from aliby_tpu_torch.ops import segsum
    from aliby_tpu_torch.test_data import render_cells

    base = np.stack([render_cells(256, 24, rng)[2] for _ in range(4)])
    shapes = [(16, 256, 256), (2, 1080, 1080), (2, 1088, 1088), (3, 200, 312)]
    for B, H, W in shapes:
        stencil_checks(rng, dev, base, B, H, W)
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
        sync()
        if not torch.equal(got, again):
            raise AssertionError(f"binned_sum_cols_batched differs between runs at {(B, H, W)}")
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
        rel, ratio = check_sums(got, want, vals, bins, n_bins, f"{(B, H, W)}")
        check_sum_order(vals, bins, n_bins, f"{(B, H, W)}")
        log(f"[kernels] {(B, H, W)}: "
            f"binned_sum_cols_batched counts exact, sums max rel err {rel:.3g}, "
            f"max err / bound {ratio:.3g}, deterministic, bit-equal to the kernel's order "
            f"on the CPU")

    # the slice-2 kernels and the widened sum, at the fused path's pixel counts
    for B, N in ((16, 256 * 256), (2, 1080 * 1080), (3, 200 * 312)):
        minmax_cases = ([(2, 65), (2, 257)] if B == 16 else [(2, 257)] if B == 2 else [(1, 257)])
        for K, n_bins in minmax_cases:
            vals = rng.normal(0, 50, (B, N, K)).astype(np.float32)
            vals[rng.random((B, N, K)) < 1e-5] = np.nan
            vals[0, 0, 0] = np.nan
            bins = rng.integers(-2, n_bins + 2, (B, N)).astype(np.int32)
            bins[0, 0] = 1
            v, b = torch.from_numpy(vals).to(dev), torch.from_numpy(bins).to(dev)
            mn, mx = segsum.binned_minmax_batched(v, b, n_bins)
            pmn, pmx = segsum.binned_minmax_batched_plain(v, b, n_bins)
            sync()
            if not (equal_nan(mn, pmn) and equal_nan(mx, pmx)) or not torch.isnan(mn).any():
                raise AssertionError(f"binned_minmax_batched != plain at {(B, N, K)}, {n_bins} bins")
        for L in (64, 256):
            table = rng.normal(0, 10, (B, L, 3)).astype(np.float32)
            table[0, 1, 0], table[-1, 2, 2], table[0, 3, 1] = np.inf, -np.inf, np.nan
            bins = rng.integers(-3, L + 3, (B, N)).astype(np.int32)
            bins[0, :3] = (1, 2, 3)
            t, b = torch.from_numpy(table).to(dev), torch.from_numpy(bins).to(dev)
            got = segsum.table_lookup_batched(t, b)
            want = segsum.table_lookup_batched_plain(t, b)
            sync()
            if not equal_nan(got, want) or not torch.isnan(got).any():
                raise AssertionError(f"table_lookup_batched != plain at {(B, N)}, L {L}")
        n_bins = 65 if B == 16 else 257
        vals = rng.normal(0, 1, (B, N, 17)).astype(np.float32)
        vals[..., 16] = 1.0
        bins = rng.integers(-2, n_bins + 2, (B, N)).astype(np.int32)
        v, b = torch.from_numpy(vals).to(dev), torch.from_numpy(bins).to(dev)
        got = segsum.binned_sum_cols_batched(v, b, n_bins)
        again = segsum.binned_sum_cols_batched(v, b, n_bins)
        want = segsum.binned_sum_cols_batched_plain(v, b, n_bins)
        sync()
        if not torch.equal(got, again):
            raise AssertionError(f"binned_sum_cols_batched K=17 differs between runs at {(B, N)}")
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
        rel, ratio = check_sums(got, want, v, b, n_bins, f"K=17 at {(B, N)}")
        check_sum_order(v, b, n_bins, f"K=17 at {(B, N)}")
        log(f"[kernels] {(B, N)} px: binned_minmax_batched {minmax_cases} and "
            f"table_lookup_batched (L 64, 256; K 3) equal to plain with NaN positions equal; "
            f"binned_sum_cols_batched K=17 counts exact, max rel err {rel:.3g}, max err / bound "
            f"{ratio:.3g}, deterministic, bit-equal to the kernel's order on the CPU")

    # adversarial sums: every pixel in one bin (4,096-add runs, a ragged N);
    # every pixel in a bin of its own among 66,049
    N = 1080 * 1080
    v = torch.from_numpy(rng.normal(0, 1, (2, N, 6)).astype(np.float32)).to(dev)
    one_bin = torch.zeros(2, N, dtype=torch.int32, device=dev)
    check_sum_order(v, one_bin, 66049, "every pixel in bin 0 of 66,049")
    check_sum_order(v[..., :1].contiguous(), one_bin, 1, "every pixel in one bin, K 1")
    own = torch.from_numpy(np.stack([rng.permutation(66049)[:65536] for _ in range(16)])
                           .astype(np.int32)).to(dev)
    v16 = torch.from_numpy(rng.normal(0, 1, (16, 65536, 6)).astype(np.float32)).to(dev)
    check_sum_order(v16, own, 66049, "every pixel in its own bin of 66,049")
    # more than 1,024 chunks in one image: the combine ranks in windows
    n_big = 4096 * 1100 + 5
    v_big = torch.from_numpy(rng.normal(0, 1, (1, n_big, 2)).astype(np.float32)).to(dev)
    b_big = torch.from_numpy(rng.integers(-1, 5, (1, n_big)).astype(np.int32)).to(dev)
    check_sum_order(v_big, b_big, 4, f"(1, {n_big}, 2) -> 4 bins, 1,101 chunks")
    t_one = cuda_ms(lambda: segsum.binned_sum_cols_batched(v, one_bin, 66049))
    t_own = cuda_ms(lambda: segsum.binned_sum_cols_batched(v16, own, 66049))
    log(f"[kernels] adversarial sums bit-equal to the kernel's order on the CPU and across runs: "
        f"(2, {N}, 6) all in one bin {t_one:.4f} ms; (16, 65536, 6) each pixel in its own bin "
        f"of 66,049 {t_own:.4f} ms; (1, {n_big}, 2) over 1,101 chunks")

    # the unbatched per-label sums: label 0, negative labels and labels past
    # max_labels are dropped; half the columns hold small integers (exact sums)
    N0, K, max_labels = SEGMENT_SUM_SHAPE
    for N in (N0, 200 * 312 + 7):
        v, lab = segment_sum_inputs(rng, N, K, max_labels, dev)
        got = segsum.segment_sum_matmul(v, lab, max_labels)
        again = segsum.segment_sum_matmul(v, lab, max_labels)
        want = segsum.segment_sum_matmul_plain(v, lab, max_labels)
        sync()
        if not torch.equal(got, again):
            raise AssertionError(f"segment_sum_matmul differs between runs at N {N}")
        if not torch.equal(got[:, K // 2:], want[:, K // 2:]):
            raise AssertionError(f"segment_sum_matmul integer-valued columns != plain at N {N}")
        rel, ratio = check_segment_sums(got, want, v, lab, max_labels, f"N {N}")
        check_kernel_order(lambda: segsum.segment_sum_matmul(v, lab, max_labels),
                           lambda: segsum.segment_sum_matmul_chunked(v.cpu(), lab.cpu(),
                                                                     max_labels),
                           f"segment_sum_matmul N {N}")
        log(f"[kernels] segment_sum_matmul ({N}, {K}) -> {max_labels} labels: integer-valued "
            f"columns exact, max rel err {rel:.3g}, max err / bound {ratio:.3g}, deterministic, "
            f"bit-equal to the kernel's order on the CPU")

    # the column grouping of the sum wrapper: 367 columns = 12 passes of <= 31 + the flag
    from aliby_tpu_torch.extract import reductions

    B, N, K, n_bins = 2, 256 * 256, 367, 65
    v = torch.from_numpy(rng.normal(0, 1, (B, N, K)).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.integers(-2, n_bins + 2, (B, N)).astype(np.int32)).to(dev)
    b[1, 5] = 7  # the pixel that turns non-finite below
    before = segsum.binned_sum_cols_batched.launches
    got = reductions.binned_sum_cols(v, b, n_bins)
    n_pass = segsum.binned_sum_cols_batched.launches - before
    want = segsum.binned_sum_cols_batched_plain(v, b, n_bins)
    narrow = reductions.binned_sum_cols(v[..., 100:120].contiguous(), b, n_bins)
    sync()
    if n_pass != 12 or got.shape != (B, n_bins, K) or not torch.equal(got[..., 100:120], narrow):
        raise AssertionError(f"binned_sum_cols K=367: {n_pass} passes, shape {tuple(got.shape)}, "
                             f"or a column's bits depend on its group")
    rel, ratio = check_sums(got, want, v, b, n_bins, "K=367")
    with kernel_order_on_cpu():
        on_cpu = reductions.binned_sum_cols(v.cpu(), b.cpu(), n_bins)
    if not same_bits(got, on_cpu):
        raise AssertionError("binned_sum_cols K=367 != the same grouping on the CPU in the "
                             "kernel's order")
    v[1, 5, 366] = float("inf")
    poisoned = reductions.binned_sum_cols(v, b, n_bins)
    keep = torch.ones(B, n_bins, dtype=torch.bool, device=dev)
    keep[1, 7] = False
    if not (torch.isnan(poisoned[1, 7]).all() and torch.equal(poisoned[keep], got[keep])):
        raise AssertionError("binned_sum_cols K=367: a non-finite value must poison all K columns "
                             "of its own bin and nothing else")
    log(f"[kernels] binned_sum_cols ({B}, {N}, {K}) -> {n_bins} bins in {n_pass} passes: max rel "
        f"err {rel:.3g}, max err / bound {ratio:.3g}; bit-equal to the CPU's grouping in the "
        f"kernel's order; a column's bits do not depend on its group; one shared non-finite flag")
    minmax_lookup_checks(rng, dev, base)


def minmax_values(rng, B, N, K):
    """(B, N, K) f32 with +-0.0 (4%), NaN, +inf and -inf here and there."""
    v = rng.normal(0, 50, (B, N, K)).astype(np.float32)
    r = rng.random((B, N, K))
    v[r < 0.02] = 0.0
    v[(r >= 0.02) & (r < 0.04)] = -0.0
    v[r > 1 - 1e-4] = np.nan
    v[(r > 1 - 2e-4) & (r <= 1 - 1e-4)] = np.inf
    v[(r > 1 - 3e-4) & (r <= 1 - 2e-4)] = -np.inf
    return v


def minmax_lookup_checks(rng, dev, base) -> None:
    """Phase 2: per-bin min/max and the lookup on adversarial inputs, each
    against its plain version (min/max equal, NaN positions equal; the
    lookup, a copy, the same bits), and the signed-zero rule of min/max."""
    from aliby_tpu_torch.ops import segsum

    labels = tiled_labels(base, 16, 256, 256).reshape(16, -1)  # objects on bin 0
    yy, xx = np.mgrid[0:256, 0:256].astype(np.float32)
    bbox = np.broadcast_to(np.stack([yy, xx], -1).reshape(1, -1, 2), (16, 65536, 2))
    perm = np.stack([rng.permutation(4096) for _ in range(2)]).astype(np.int32)
    # (what, values, bins, n_bins)
    minmax_cases = [
        ("label images, bbox coordinates", bbox.copy(), labels, 65),
        ("label images, K 1", minmax_values(rng, 16, 65536, 1), labels, 65),
        ("label images, K 2", minmax_values(rng, 16, 65536, 2), labels, 65),
        ("every pixel in bin 0", minmax_values(rng, 16, 65536, 2),
         np.zeros((16, 65536), np.int32), 65),
        ("one pixel per bin of 4,096", minmax_values(rng, 2, 4096, 1), perm, 4096),
        ("ragged (1, 62401, 2)", minmax_values(rng, 1, 62401, 2),
         rng.integers(-2, 67, (1, 62401)).astype(np.int32), 65),
        ("ragged (3, 62401, 3)", minmax_values(rng, 3, 62401, 3),
         labels[:3, :62401].copy(), 65),
        ("n_bins x K = 2,048 x 2", minmax_values(rng, 2, 65536, 2),
         rng.integers(-1, 2049, (2, 65536)).astype(np.int32), 2048),
        ("n_bins x K = 1,024 x 4", minmax_values(rng, 2, 65536, 4),
         rng.integers(-1, 1025, (2, 65536)).astype(np.int32), 1024),
    ]
    for what, vals, bins, n_bins in minmax_cases:
        v, b = torch.from_numpy(vals).to(dev), torch.from_numpy(bins).to(dev)
        got = segsum.binned_minmax_batched(v, b, n_bins)
        want = segsum.binned_minmax_batched_plain(v, b, n_bins)
        sync()
        if not agree(got, want):
            raise AssertionError(f"binned_minmax_batched != plain on {what}")
    # signed zeros: every value +-0.0 on label images; a bin holding both
    # gives min -0.0 and max +0.0, a bin of one sign that zero
    neg = rng.random((16, 65536)) < 0.5
    zeros = np.where(neg, np.float32(-0.0), np.float32(0.0))[..., None]
    mn, mx = segsum.binned_minmax_batched(torch.from_numpy(zeros).to(dev),
                                          torch.from_numpy(labels).to(dev), 65)
    want_neg = np.zeros((16, 65), bool)
    want_pos = np.zeros((16, 65), bool)
    for i in range(16):
        want_neg[i, np.unique(labels[i][neg[i]])] = True
        want_pos[i, np.unique(labels[i][~neg[i]])] = True
    present = want_neg | want_pos
    mn, mx = mn.cpu()[..., 0].numpy(), mx.cpu()[..., 0].numpy()
    if not ((mn[present] == 0).all() and (mx[present] == 0).all()
            and np.array_equal(np.signbit(mn[present]), want_neg[present])
            and np.array_equal(np.signbit(mx[present]), ~want_pos[present])
            and (want_neg & want_pos).any()):
        raise AssertionError("binned_minmax_batched: -0.0 must count as below +0.0")

    # the lookup: (what, table, bins)
    def table(B, L, K):
        t = rng.normal(0, 10, (B, L, K)).astype(np.float32)
        t[0, 1, 0], t[-1, 2, K - 1], t[0, 3, K - 1], t[0, 4, 0] = np.inf, -np.inf, np.nan, -0.0
        return t

    lookup_cases = [("label images, L 64, K 3", table(16, 64, 3), labels),
                    ("label images, L 64, K 5", table(16, 64, 5), labels),
                    ("every pixel in bin 4, K 3", table(16, 64, 3),
                     np.full((16, 65536), 4, np.int32)),
                    ("one pixel per bin of 4,096, K 3", table(2, 4096, 3), perm),
                    ("L x K = 12,288 x 1", table(2, 12288, 1),
                     rng.integers(-3, 12291, (2, 65536)).astype(np.int32)),
                    ("L x K = 1,536 x 8", table(2, 1536, 8),
                     rng.integers(-3, 1539, (2, 65536)).astype(np.int32))]
    for K in (*range(1, 9), 13):
        for B in (1, 3):
            lookup_cases.append((f"ragged ({B}, 62401), L 64, K {K}", table(B, 64, K),
                                 rng.integers(-3, 67, (B, 62401)).astype(np.int32)))
    for what, tab, bins in lookup_cases:
        t, b = torch.from_numpy(tab).to(dev), torch.from_numpy(bins).to(dev)
        got = segsum.table_lookup_batched(t, b)
        want = segsum.table_lookup_batched_plain(t, b)
        sync()
        if not same_bits(got, want):
            raise AssertionError(f"table_lookup_batched != plain (bits) on {what}")
    log(f"[kernels] binned_minmax_batched on {len(minmax_cases)} adversarial inputs (label "
        f"images, one bin, one pixel per bin, ragged N, n_bins x K at 4,096) equal to plain, NaN "
        f"positions equal; -0.0 below +0.0 on label images; table_lookup_batched on "
        f"{len(lookup_cases)} (label images, one bin, one pixel per bin, L x K at 12,288, ragged "
        f"N at K 1-8 and 13) the same bits as plain")


def segment_sum_inputs(rng, N, K, max_labels, dev):
    """(N, K) values, the upper half of the columns small integers, and (N,)
    labels from -2 to max_labels + 2."""
    vals = rng.normal(0, 1, (N, K)).astype(np.float32)
    vals[:, K // 2:] = rng.integers(0, 4, (N, K - K // 2))
    labels = rng.integers(-2, max_labels + 3, N).astype(np.int32)
    return torch.from_numpy(vals).to(dev), torch.from_numpy(labels).to(dev)


def check_segment_sums(got, want, values, labels, max_labels, what):
    """``check_sums`` for the unbatched kernel: label k is bin k - 1 of one image."""
    return check_sums(got[None], want[None], values[None], (labels - 1)[None], max_labels,
                      f"segment_sum_matmul {what}")


def check_sums(got, want, values, bins, n_bins, what: str) -> float:
    """Per-bin sums of the kernel against the plain version's on the same
    inputs: the counts (the input columns that hold only 0 and 1) exact;
    every sum of n terms t within 2 (n - 1) eps sum|t| of the plain one, the
    worst-case bound on two f32 summations of the same terms in different
    orders (n - 1 roundings each; the plain version adds with atomics).
    Returns the largest relative error |got - want| / |want| over the
    nonzero sums and the largest |got - want| / bound."""
    from aliby_tpu_torch.ops import segsum

    K = values.shape[-1]
    v = values.reshape(-1, K)
    counts = ((v == 0) | (v == 1)).all(dim=0)
    if not torch.equal(got[..., counts], want[..., counts]):
        raise AssertionError(f"the sum kernel's counts != plain ({what})")
    magnitude = segsum.binned_sum_cols_batched_plain(values.abs(), bins, n_bins)
    n = segsum.binned_sum_cols_batched_plain(torch.ones_like(values[..., :1]), bins, n_bins)
    bound = 2 * (n - 1).clamp_min(0) * F32_EPS * magnitude
    bad = (got - want).abs() > bound
    if bad.any():
        raise AssertionError(f"the sum kernel's sums beyond the summation bound of plain "
                             f"({what}): {int(bad.sum())} sums")
    d = (got - want).abs()
    nz, off = want != 0, d > 0
    rel = float((d[nz] / want.abs()[nz]).max()) if nz.any() else 0.0
    return rel, float((d[off] / bound[off]).max()) if off.any() else 0.0


def agree(got, want) -> bool:
    """Bit-equal, NaN positions equal (tuples element by element)."""
    if isinstance(got, (tuple, list)):
        return all(agree(g, w) for g, w in zip(got, want))
    return equal_nan(got, want)


def kernel_row(name, kernel, plain, library, bytes_, ops, shape, launches,
               sum_inputs=None, ops_rate=PEAK_F32_OPS_S) -> dict:
    """One kernel's line of the report: its time beside its plain version's,
    the library call's (where one exists) and its bound. The kernel's
    output must equal the plain version's on these inputs (per-bin sums,
    ``sum_inputs`` = (values, bins, n_bins): within ``check_sums``' bound)."""
    out_k, out_p = kernel(), plain()
    sync()
    err = max_abs_err(out_k, out_p)
    extra = {}
    if sum_inputs is not None:
        extra["max_rel_err"], extra["max_err_over_bound"] = check_sums(
            out_k, out_p, *sum_inputs, f"{name} {tuple(shape)}")
    elif not agree(out_k, out_p):
        raise AssertionError(f"{name} != plain on the main path's inputs {tuple(shape)}")
    t_bytes, t_ops = bytes_ / PEAK_BYTES_S * 1e3, ops / ops_rate * 1e3
    source = "aliby_tpu_torch/kernels/csrc/" + (
        "stencil.cu" if name in ("successor_prop", "diffuse_heat") else "segsum.cu")
    ms, plain_ms, *library_ms = cuda_ms_turns([kernel, plain] + [library] * (library is not None))
    r = {
        "name": name, "route": "cuda", "source": source, "replaces": REPLACES[name],
        "launches": launches, "max_abs_err": err, **extra, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms[0] if library_ms else None, "shape": list(shape),
    }
    rel = (f", max rel err {extra['max_rel_err']:.3g}, max err / bound "
           f"{extra['max_err_over_bound']:.3g}" if extra else "")
    log(f"[report] {name} {tuple(shape)}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
        f"library {r['library_ms']} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
        f"max abs err {err}{rel}, launches on the path {launches}")
    return r


def device_by_launch(fn, calls: int = 20, windows: int = 3) -> dict:
    """Device time of one launch of each kernel that one call of ``fn``
    launches, by name, and the share of the ``calls`` calls' launches the
    profiler recorded (torch.profiler). A short window records only some of
    its launches (between 45% and all of them on the H100 runs of this
    script), so the time is the mean over the launches recorded, from the
    fullest of ``windows`` windows, and the recorded count is no count of
    launches per call: those follow from the wrapper's code, and the cuda
    tests and the step's kernel count check them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync()
    best = {}  # name -> (launches recorded, ms per launch)
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            sync()
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
                name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
                if e.count > best.get(name, (0, 0.0))[0]:
                    best[name] = (e.count, e.self_device_time_total / e.count / 1e3)
    return {name: (t, n / calls) for name, (n, t) in best.items()}


def host_ms_per_call(fn, calls: int = 200) -> float:
    """Host time of one call of ``fn``: perf_counter over ``calls`` calls
    issued back to back, read before the synchronize that ends them."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e3
    sync()
    return host


def run_ms_per_call(fn, calls: int = 50, reps: int = 5) -> float:
    """Time per call of ``fn`` within a run of ``calls`` calls issued back to
    back (CUDA events around the run, the median of ``reps`` runs): the rate
    at which a step, whose host issues calls while the card works, gets
    them done."""
    fn()
    sync()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        sync()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def report_costs(row: dict, fn, library) -> None:
    """Adds what one call of a wrapper costs to its kernel's row (the device
    time of each launch, the host time of the call, the library call's host
    time) and logs it beside the time per call and the ratio to the library
    call."""
    parts = device_by_launch(fn)
    row.update(device_ms_per_launch={k: t for k, (t, _) in parts.items()},
               host_ms=host_ms_per_call(fn), library_host_ms=host_ms_per_call(library),
               ms_in_a_run=run_ms_per_call(fn), library_ms_in_a_run=run_ms_per_call(library))
    device = ("not measured (the profiler saw no CUDA kernels)" if not parts else ", ".join(
        f"{k} {t:.4f} ms (recorded {n:.2f} a call)" for k, (t, n) in parts.items()))
    log(f"[report] {row['name']} {tuple(row['shape'])} per call: {row['ms']:.4f} ms (CUDA events), "
        f"device per launch {device}, host {row['host_ms']:.4f} ms (the wrapper); library "
        f"{row['library_ms']:.4f} ms (host {row['library_host_ms']:.4f} ms), kernel / library "
        f"{row['ms'] / row['library_ms']:.3f}; in a run of 50 calls {row['ms_in_a_run']:.4f} ms "
        f"a call, library {row['library_ms_in_a_run']:.4f} ms, kernel / library "
        f"{row['ms_in_a_run'] / row['library_ms_in_a_run']:.3f}")


def stencil_costs(row: dict, fn, wrapper, max_launches: int) -> None:
    """Adds what one stencil call costs to its kernel's row: launches a
    call (the wrapper's counter), the device time of each launch, the
    wrapper's host time, the time a call within a run; fails above
    ``max_launches`` launches a call."""
    before = wrapper.launches
    fn()
    per_call = wrapper.launches - before
    parts = device_by_launch(fn)
    row.update(launches_per_call=per_call,
               device_ms_per_launch={k: t for k, (t, _) in parts.items()},
               host_ms=host_ms_per_call(fn), ms_in_a_run=run_ms_per_call(fn))
    device = ("not measured (the profiler saw no CUDA kernels)" if not parts else ", ".join(
        f"{k} {t:.4f} ms (recorded {n:.2f} a call)" for k, (t, n) in parts.items()))
    log(f"[report] {row['name']} {tuple(row['shape'])} per call: {row['ms']:.4f} ms (CUDA events), "
        f"{per_call} launches, device per launch {device}, host {row['host_ms']:.4f} ms (the "
        f"wrapper), in a run of 50 calls {row['ms_in_a_run']:.4f} ms a call; bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    if per_call > max_launches:
        raise AssertionError(f"{row['name']} made {per_call} launches a call at "
                             f"{STENCIL_ROUNDS} rounds (at most {max_launches})")


def binned_sum_row(vals, bins, n_bins, launches, name="binned_sum_cols_batched") -> dict:
    from aliby_tpu_torch.ops import segsum

    Bv, K = bins.shape[0], vals.shape[-1]
    N = bins[0].numel()
    check_sum_order(vals, bins, n_bins, f"{(Bv, N, K, n_bins)} (phase 4)")
    idx = segsum._flat_index(bins.reshape(Bv, -1), n_bins)
    flat_vals = vals.reshape(-1, K).to(torch.float32)
    acc = torch.zeros(Bv * n_bins + 1, K, device=vals.device)  # index_add returns a new tensor
    return kernel_row(name,
                      lambda: segsum.binned_sum_cols_batched(vals, bins, n_bins),
                      lambda: segsum.binned_sum_cols_batched_plain(vals, bins, n_bins),
                      lambda: acc.index_add(0, idx, flat_vals),
                      bytes_=Bv * N * (4 * K + bins.element_size()) + Bv * n_bins * K * 4,
                      ops=Bv * N * K, shape=(Bv, N, K, n_bins), launches=launches,
                      sum_inputs=(vals, bins, n_bins))


def measure_kernels(recorded: dict, launches: dict) -> dict:
    """Time each kernel on the inputs the main path gave it (recorded), beside
    its plain version, the library call where one exists, and its bound."""
    from aliby_tpu_torch.ops import segsum, stencil

    out = {}

    def measure(name, *args, **kwargs):
        out[name] = kernel_row(name, *args, **kwargs, launches=launches[name])

    n = STENCIL_ROUNDS
    if "successor_prop" in recorded:
        d, k = recorded["successor_prop"][:2]
        B, H, W = d.shape
        px = B * H * W
        # the kernel computes every round (no early exit): n selects a pixel
        measure("successor_prop", lambda: stencil.successor_prop(d, k, n),
                lambda: stencil.successor_prop_plain(d, k, n), None,
                bytes_=12 * px, ops=n * px, shape=(B, H, W))
        stencil_costs(out["successor_prop"], lambda: stencil.successor_prop(d, k, n),
                      stencil.successor_prop, SUCC_MAX_LAUNCHES)
    if "diffuse_heat" in recorded:
        lab, src = recorded["diffuse_heat"][:2]
        B, H, W = lab.shape
        px = B * H * W
        fg = lab > 0
        n_fg, n_src = int(fg.sum()), int((src != 0).sum())
        n_same = sum(int(((stencil.shift(lab, dy, dx, -1) == lab) & fg).sum())
                     for dy, dx in stencil.OFFSETS)
        measure("diffuse_heat", lambda: stencil.diffuse_heat(lab, src, n),
                lambda: stencil.diffuse_heat_plain(lab, src, n), None,
                bytes_=12 * px, shape=(B, H, W), ops_rate=PEAK_F32_INSTR_S,
                ops=n * (n_same + n_src + n_fg * DIFFUSE_DIV_INSTR))
        out["diffuse_heat"]["foreground_share"] = n_fg / px
        stencil_costs(out["diffuse_heat"], lambda: stencil.diffuse_heat(lab, src, n),
                      stencil.diffuse_heat, DIFFUSE_MAX_LAUNCHES)
    if "binned_sum_cols_batched" in recorded:
        out["binned_sum_cols_batched"] = binned_sum_row(*recorded["binned_sum_cols_batched"],
                                                        launches["binned_sum_cols_batched"])
    if "binned_minmax_batched" in recorded:
        vals, bins, n_bins = recorded["binned_minmax_batched"]
        Bv, K = bins.shape[0], vals.shape[-1]
        N = bins[0].numel()
        idx = segsum._flat_index(bins.reshape(Bv, -1), n_bins).unsqueeze(1).expand(-1, K)
        flat_vals = vals.reshape(-1, K).to(torch.float32)
        mn0 = torch.full((Bv * n_bins + 1, K), float("inf"), device=vals.device)
        mx0 = torch.full((Bv * n_bins + 1, K), float("-inf"), device=vals.device)
        measure("binned_minmax_batched",
                lambda: segsum.binned_minmax_batched(vals, bins, n_bins),
                lambda: segsum.binned_minmax_batched_plain(vals, bins, n_bins),
                lambda: (mn0.scatter_reduce(0, idx, flat_vals, "amin"),
                         mx0.scatter_reduce(0, idx, flat_vals, "amax")),
                bytes_=Bv * N * (4 * K + 4) + 2 * Bv * n_bins * K * 4, ops=2 * Bv * N * K,
                shape=(Bv, N, K, n_bins))
        row = out["binned_minmax_batched"]
        report_costs(row, lambda: segsum.binned_minmax_batched(vals, bins, n_bins),
                     lambda: (mn0.scatter_reduce(0, idx, flat_vals, "amin"),
                              mx0.scatter_reduce(0, idx, flat_vals, "amax")))
        if row["ms"] > row["library_ms"]:
            raise AssertionError(f"binned_minmax_batched slower than scatter_reduce at "
                                 f"{tuple(row['shape'])}")
    if "table_lookup_batched" in recorded:
        table, bins = recorded["table_lookup_batched"]
        Bt, L, K = table.shape
        N = bins[0].numel()
        flat_tab = table.reshape(Bt * L, K)
        fidx = (bins.reshape(Bt, -1).clamp(0, L - 1).to(torch.int64)
                + torch.arange(Bt, device=bins.device)[:, None] * L).reshape(-1)
        measure("table_lookup_batched",
                lambda: segsum.table_lookup_batched(table, bins),
                lambda: segsum.table_lookup_batched_plain(table, bins),
                lambda: flat_tab[fidx],
                bytes_=Bt * N * 4 + Bt * N * K * 4 + Bt * L * K * 4, ops=0,
                shape=(Bt, N, L, K))
        report_costs(out["table_lookup_batched"], lambda: segsum.table_lookup_batched(table, bins),
                     lambda: flat_tab[fidx])
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
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
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


def fused_stage_breakdown(step, pixels, engines, reps: int = 5) -> None:
    """Host time of each stage of the fused step, every stage serialised
    with synchronize() (median of ``reps``): segmentation (both objects, one
    batch), each feature family (the MAD bisection of intensity and the
    minimum enclosing circle of the zernike pass shown apart), and the rest
    (z-reductions, label packing, the readback)."""
    from aliby_tpu_torch.extract import features, texture

    times: dict[str, float] = {}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync()
            times[name] = times.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
            return out
        return wrapper

    apart = {"intensity MAD": (features, "mad_from_sorted"),
             "zernike MEC": (texture, "minimum_enclosing_circle")}
    stages = {"sizeshape": (features, "sizeshape"), "intensity": (features, "intensity"),
              "feret": (features, "feret"), "texture": (texture, "texture"),
              "radial_distribution": (texture, "radial_distribution"),
              "zernike family": (texture, "zernike_family_multi"), **apart}
    saved = {label: getattr(mod, name) for label, (mod, name) in stages.items()}
    saved_corr = dict(features.CORRELATION_FEATURES)
    for e in engines:
        e._segment_all = timed("segmentation", e._segment_all)
    for label, (mod, name) in stages.items():
        setattr(mod, name, timed(label, saved[label]))
    for name, fn in saved_corr.items():
        features.CORRELATION_FEATURES[name] = timed("coloc", fn)
    runs = []
    try:
        for _ in range(reps):
            times.clear()
            t0 = time.perf_counter()
            step.fused(pixels)
            sync()
            total = (time.perf_counter() - t0) * 1e3
            parts = dict(times)
            parts["packing and the rest"] = total - sum(
                v for k, v in parts.items() if k not in apart)
            parts["total"] = total
            runs.append(parts)
    finally:
        for e in engines:
            del e._segment_all
        for label, (mod, name) in stages.items():
            setattr(mod, name, saved[label])
        features.CORRELATION_FEATURES.update(saved_corr)
    med = {k: statistics.median(r.get(k, 0.0) for r in runs) for k in runs[0]}
    total = med.pop("total")
    log(f"[stages] fused step {tuple(pixels.shape)}: total {total:.2f} ms; " + ", ".join(
        f"{k} {v:.2f} ms ({100 * v / total:.0f}%)" for k, v in med.items()))


def device_share(fn, what="one batch", warmup=True, host_ops=True) -> dict | None:
    """Device-busy share of one run of ``fn`` (after a warm-up run unless
    ``warmup`` is False) and its top kernels, from torch.profiler (CUDA
    kernel self time over wall time); None when the profiler saw no CUDA
    kernels. ``host_ops=False`` records the card's activity alone (the
    host's op events of a ~50k-kernel window take ~20 s to process)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
    sync()
    activities = [ProfilerActivity.CPU] * host_ops + [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (the aten ops' rows repeat their kernels' time)
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if busy_ms == 0:
        log(f"[profile] {what}: device time not measured (the profiler saw no CUDA kernels)")
        return None
    n_kernels = sum(e.count for e in events)
    log(f"[profile] {what}: wall {wall_ms:.2f} ms, device busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%), idle {100 - 100 * busy_ms / wall_ms:.1f}%, "
        f"{n_kernels} kernels")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"[profile]   {e.key[:70]}: {e.self_device_time_total / 1e3:.3f} ms in {e.count} calls")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
            "kernels": n_kernels}


def sum_breakdown(costes, wide_costes, segment_shape, dev) -> None:
    """Device time of each launch of one sum-kernel call (``device_by_launch``;
    a call launches pass 1, alloc, scatter and combine once and two memsets):
    the costes histogram at 256^2 and at 1080^2, and segment_sum_matmul at
    phase 2's shape."""
    from aliby_tpu_torch.ops import segsum

    N, K, L = segment_shape
    v, lab = segment_sum_inputs(np.random.default_rng(6), N, K, L, dev)
    calls = {"costes histogram": lambda: segsum.binned_sum_cols_batched(*costes),
             "costes histogram 1080^2": lambda: segsum.binned_sum_cols_batched(*wide_costes),
             "segment_sum_matmul": lambda: segsum.segment_sum_matmul(v, lab, L)}
    for what, fn in calls.items():
        parts = device_by_launch(fn)
        if not parts:
            log(f"[report] {what}: device time by launch not measured (the profiler saw no "
                f"CUDA kernels)")
            continue
        log(f"[report] {what}, device time per launch: " + ", ".join(
            f"{k} {t:.4f} ms (recorded {n:.2f} a call)" for k, (t, n) in parts.items()))


def peak_gb(fn) -> float:
    sync()
    torch.cuda.reset_peak_memory_stats()
    fn()
    sync()
    return torch.cuda.max_memory_allocated() / 1e9


@contextlib.contextmanager
def kernel_order_on_cpu():
    """The port's CPU path takes its per-bin sums in the CUDA kernel's order
    (``segsum.binned_sum_cols_batched_chunked``) inside the block."""
    from aliby_tpu_torch.ops import segsum

    plain = segsum.binned_sum_cols_batched_plain
    segsum.binned_sum_cols_batched_plain = segsum.binned_sum_cols_batched_chunked
    try:
        yield
    finally:
        segsum.binned_sum_cols_batched_plain = plain


def compare_features(gpu_feats, cpu_feats, fields, what: str) -> None:
    """The card's feature blocks against the CPU's on the fields whose
    labels are equal, at the tolerances of ``aliby_tpu_torch.extract.tolerances``
    (those of the CPU parity tests): no value beyond them outside the
    threshold-decided features, and at most ``THRESHOLD_SHARE`` of those."""
    from aliby_tpu_torch.extract.tolerances import (
        THRESHOLD_DECIDED,
        THRESHOLD_SHARE,
        beyond_tolerance,
        tolerance,
    )

    worst: dict[str, float] = {}
    off: dict[str, int] = {}  # feature -> object values beyond tolerance
    flips, n_thr, n_equal, n_all = 0, 0, 0, 0
    for obj_g, obj_c in zip(gpu_feats, cpu_feats):
        for (names, g_arr), (c_names, c_arr) in zip(obj_g, obj_c):
            if names != c_names or g_arr.shape != c_arr.shape:
                raise AssertionError("GPU/CPU feature names or shapes differ")
            g_arr = g_arr[:, fields].astype(np.float64)
            c_arr = c_arr[:, fields].astype(np.float64)
            n_equal += int(np.array_equal(g_arr, c_arr, equal_nan=True))
            n_all += 1
            row = {name: i for i, name in enumerate(names)}
            for i, name in enumerate(names):
                entry, feat = name.split("::", 1)

                def ref(other, entry=entry):
                    return c_arr[row[f"{entry}::{other}"]]

                g, c = g_arr[i], c_arr[i]
                beyond = beyond_tolerance(feat, g, c, ref)
                if feat in THRESHOLD_DECIDED:
                    n_thr += int((~np.isnan(g) | ~np.isnan(c)).sum())
                    flips += int(beyond.sum())
                    continue
                if beyond.any():
                    off[feat] = off.get(feat, 0) + int(beyond.sum())
                d = np.nan_to_num(np.abs(g - c))
                if d.max() == 0:
                    continue
                rtol, atol = tolerance(feat, ref)
                absc = np.nan_to_num(np.abs(c))
                # in units of the tolerance (of f32 ulps for exact features)
                tol = np.maximum(atol + rtol * absc, F32_EPS * absc + 1e-30)
                worst[feat] = max(worst.get(feat, 0.0), float((d / tol).max()))
    top = sorted(worst.items(), key=lambda kv: -kv[1])[:8]
    log(f"[fused] f32 GPU vs CPU ({what}): {n_equal}/{n_all} feature blocks bit-equal; "
        f"largest error / tolerance: " + (", ".join(f"{k} {v:.3g}" for k, v in top) or "none"))
    log(f"[fused] f32 GPU vs CPU ({what}): costes/costes_2 differ on {flips} of {n_thr} object "
        f"values (at most {THRESHOLD_SHARE:.0%}); values beyond tolerance elsewhere: {off or 'none'}")
    if flips > max(1, THRESHOLD_SHARE * n_thr):
        raise AssertionError(f"costes differs GPU/CPU on {flips} of {n_thr} values "
                             f"(> {THRESHOLD_SHARE:.0%})")
    if off:
        raise AssertionError(f"GPU/CPU feature values beyond tolerance: {off}")


def fused_checks(what: str, pixels, slice1_labels, reps: int, profile: bool):
    """Phase 3, slices 2 and 3: one pipeline of ``FUSED_PATHS`` through the
    fused step, its five kernels counted over one step."""
    from aliby_tpu_torch.engine.builders import build_pipeline_steps
    from aliby_tpu_torch.engine.compiled import try_compile
    from aliby_tpu_torch.engine.fused import results_from_fused
    from aliby_tpu_torch.extract import features, reductions
    from aliby_tpu_torch.models import flows
    from aliby_tpu_torch.models.segment import dispatch_segmenter
    from aliby_tpu_torch.ops import segsum, stencil

    kwargs, rows, golden_file = FUSED_PATHS[what]
    wrappers = {"successor_prop": stencil.successor_prop, "diffuse_heat": stencil.diffuse_heat,
                "binned_sum_cols_batched": segsum.binned_sum_cols_batched,
                "binned_minmax_batched": segsum.binned_minmax_batched,
                "table_lookup_batched": segsum.table_lookup_batched,
                "segment_sum_matmul": segsum.segment_sum_matmul}
    # counted with the others, and held to 0: no production path calls it
    off_path = {"segment_sum_matmul"}
    step = try_compile(build_pipeline_steps(**kwargs))
    if step is None:
        raise AssertionError(f"try_compile found the {what} pipeline ineligible")
    t0 = time.perf_counter()
    step.fused(pixels)  # warm-up
    t_first = time.perf_counter() - t0

    def sum_of(K, n_bins=None):
        return lambda v, b, n: v.shape[-1] == K and n_bins in (None, n)

    recorders = {
        "successor_prop": Recorder(flows, "successor_prop"),
        "diffuse_heat": Recorder(flows, "diffuse_heat"),
        # sizeshape's moment pass: 16 columns + the non-finite indicator
        "binned_sum_cols_batched": Recorder(reductions, "binned_sum_cols_batched", sum_of(17)),
        "binned_minmax_batched": Recorder(reductions, "binned_minmax_batched"),
        "table_lookup_batched": Recorder(reductions, "table_lookup_batched",
                                         lambda t, *a: t.shape[-1] == 3),
        "costes histogram": Recorder(features, "binned_sum_cols_batched"),
        # the default bank's shapes: a zernike entry's first group (31 columns
        # + the indicator), the radial distribution's (label, ring) bins,
        # texture's one-column range, the zernike pass's per-channel lookup
        "zernike group": Recorder(reductions, "binned_sum_cols_batched", sum_of(32)),
        "radial rings": Recorder(reductions, "binned_sum_cols_batched", sum_of(11)),
        "texture range": Recorder(reductions, "binned_minmax_batched",
                                  lambda v, *a: v.shape[-1] == 1),
        "channel lookup": Recorder(reductions, "table_lookup_batched",
                                   lambda t, *a: t.shape[-1] == 5),
    }
    # the widths of every min/max and lookup call
    tallies = [Tally(reductions, "binned_minmax_batched",
                     lambda v, b, n: f"K {v.shape[-1]}, {n} bins"),
               Tally(reductions, "table_lookup_batched",
                     lambda t, b: f"K {t.shape[-1]}, L {t.shape[1]}, {b[0].numel()} px")]
    for w in wrappers.values():
        w.launches = 0
    with recording([*recorders.values(), *tallies]):
        t0 = time.perf_counter()
        run1 = step.fused(pixels)
        t_run1 = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    log(f"[fused] {what} step, 8 fields x 2 objects: first call {t_first * 1e3:.1f} ms, "
        f"counted run {t_run1 * 1e3:.1f} ms; launches {launches}")
    for t in tallies:
        log(f"[fused] {what} step, {t.name} calls by width: {dict(t.counts)}")
    for name, n in launches.items():
        if name in off_path:
            if n != 0:
                raise AssertionError(f"kernel {name} has no caller on the fused path, yet was "
                                     f"launched {n} times ({what})")
        elif n <= 0:
            raise AssertionError(f"kernel {name} was not launched on the fused path ({what})")
    run2 = step.fused(pixels)
    for a, b in zip(run1["labels"], run2["labels"]):
        if not np.array_equal(a, b):
            raise AssertionError(f"fused labels differ between runs ({what})")
    for obj1, obj2 in zip(run1["features"], run2["features"]):
        for (n1, a1), (n2, a2) in zip(obj1, obj2):
            if n1 != n2 or not np.array_equal(a1, a2, equal_nan=True):
                raise AssertionError(f"fused feature blocks differ between runs ({what})")
    for oi, (fused, seg) in enumerate(zip(run1["labels"], slice1_labels)):
        if fused.shape != (8, 256, 256) or not np.array_equal(fused, np.stack(seg)):
            raise AssertionError(f"fused labels != segment_grouped labels (object {oi}, {what})")
    shapes = [[a.shape for _, a in o] for o in run1["features"]]
    if shapes != [[(n, 8, 64) for n in rows]] * 2 or step.fused.state != {"cap": 64, "u8": True}:
        raise AssertionError(f"fused feature shapes {shapes}, state {step.fused.state} ({what})")
    columns = set()
    for ti, (names, arr) in enumerate(run1["features"][0]):
        res = results_from_fused(step.fused.plans[0][ti], names, arr, run1["labels"][0])
        columns |= set(res.columns()) - {"tile", "label"}
    with open(os.path.join(ROOT, "tests", "golden", golden_file)) as f:
        golden = {c for c in f.read().splitlines() if c and not c.startswith("metadata_")}
    if columns != golden:
        raise AssertionError(f"column set != golden anchor {golden_file}: {len(columns)} vs "
                             f"{len(golden)}, missing {sorted(golden - columns)[:5]}, "
                             f"extra {sorted(columns - golden)[:5]}")
    log(f"[fused] {what}: labels equal to segment_grouped's; labels and feature block identical "
        f"across runs; {len(columns)} columns = the golden anchor {golden_file} (metadata columns "
        f"apart); feature blocks {shapes[0]} per object, state {step.fused.state}")

    ms = host_ms(lambda: step.fused(pixels), reps=reps)
    log(f"[fused] {what} steady state: {ms:.1f} ms per step = {8e3 / ms:.2f} fields/s "
        f"(8 fields x 2 objects)")
    # try_compile's segmenters share the engine cache with dispatch_segmenter
    fused_stage_breakdown(step, pixels, [dispatch_segmenter("cellpose", 0).engine], reps=reps)
    if profile:
        device_share(lambda: step.fused(pixels), f"one fused step ({what})")
    gb = peak_gb(lambda: step.fused(pixels))
    log(f"[fused] {what}: peak device memory of one step {gb:.3f} GB")
    recorded = {k: r.args for k, r in recorders.items() if r.args is not None}
    return step, recorded, launches, {"fields_per_s": 8e3 / ms, "step_ms": ms,
                                      "first_ms": t_first * 1e3, "peak_gb": gb}


def fused_wide_pass(what: str, step, big) -> dict:
    """The 1080x1080 field overflows the cap of 64: the sticky wide pass."""
    rows = FUSED_PATHS[what][1]
    t0 = time.perf_counter()
    gb = peak_gb(lambda: step.fused(big))
    t_big = time.perf_counter() - t0
    out = step.fused(big)
    shapes = [[a.shape for _, a in o] for o in out["features"]]
    lmax = [int(m.max()) for m in out["labels"]]
    # the sticky rule: wider than the cap of 64 -> cap 256; a label above 255
    # -> uint16 from then on (the 8 fields before carry at most 64)
    want = {"cap": 256, "u8": max(lmax) <= 255}
    if (step.fused.state != want or shapes != [[(n, 1, 256) for n in rows]] * 2
            or not 64 < max(lmax) <= 256):
        raise AssertionError(f"1080x1080 wide pass ({what}): state {step.fused.state} (want "
                             f"{want}), shapes {shapes}, objects {lmax}")
    ms = host_ms(lambda: step.fused(big), reps=3)
    log(f"[fused] {what}, 1080x1080 field: objects {lmax}, state {step.fused.state} (wide pass, "
        f"{'uint8 kept' if want['u8'] else 'uint16 readback'}), first call {t_big * 1e3:.1f} ms, "
        f"steady {ms:.1f} ms, peak memory {gb:.3f} GB")
    return {"field_1080_ms": ms, "field_1080_peak_gb": gb}


def fused_gpu_vs_cpu(what: str, pixels) -> None:
    """The f32 fused step on the card (TF32 off) against the port on the CPU.

    The CPU takes its per-bin sums in the card's order (``kernel_order_on_cpu``),
    so that what is compared is the rest of the arithmetic; phases 2 and 4
    hold the sums themselves to that order bit for bit."""
    from aliby_tpu_torch.engine.builders import build_pipeline_steps
    from aliby_tpu_torch.engine.compiled import try_compile

    pipeline = build_pipeline_steps(
        **FUSED_PATHS[what][0], segmenter_extra_kwargs={"model_kwargs": {"dtype": torch.float32}})
    gpu = try_compile(pipeline).fused(pixels)
    with kernel_order_on_cpu():
        t0 = time.perf_counter()
        cpu = try_compile(pipeline, device="cpu").fused(pixels)
        t_cpu = time.perf_counter() - t0
    fields = [f for f in range(pixels.shape[0]) if all(
        np.array_equal(g[f], c[f]) for g, c in zip(gpu["labels"], cpu["labels"]))]
    log(f"[fused] {what}, f32 GPU vs CPU (CPU step {t_cpu:.1f} s, sums in the kernel's order): "
        f"labels bit-equal on {len(fields)}/{pixels.shape[0]} fields; features compared there")
    if len(fields) < pixels.shape[0] // 2:
        raise AssertionError(f"f32 GPU/CPU labels differ on more than half the fields ({what})")
    compare_features(gpu["features"], cpu["features"], fields,
                     f"{what}, sums in the kernel's order")


def bf16_vs_f32_labels(bf16, f32, what: str) -> None:
    """The main path's bf16 labels on the card against f32 labels on the
    card of the same fields: per label map, object counts within
    max(1, BF16_COUNT_SHARE of the f32 count) and the worst matched IoU
    (both ways) at least BF16_MIN_IOU."""
    worst_iou, worst_diff, bad = 1.0, 0, []
    for obj, (a, b) in enumerate(zip(bf16, f32)):
        for f, (x, y) in enumerate(zip(a, b)):
            nx, ny = int(x.max()), int(y.max())
            iou = min(matched_iou(x, y), matched_iou(y, x))
            worst_iou, worst_diff = min(worst_iou, iou), max(worst_diff, abs(nx - ny))
            if abs(nx - ny) > max(1, BF16_COUNT_SHARE * ny) or iou < BF16_MIN_IOU:
                bad.append(f"object {obj} field {f}: {nx} vs {ny} objects, IoU {iou:.4f}")
    log(f"[slice] bf16 vs f32 labels on the card ({what}): largest object-count difference "
        f"{worst_diff}, worst matched IoU {worst_iou:.6f} (bound: counts within max(1, "
        f"{BF16_COUNT_SHARE:.0%}), IoU >= {BF16_MIN_IOU})")
    if bad:
        raise AssertionError(f"bf16 labels beyond the bound against f32 ({what}): {bad}")


def raster_checks(seg_labels, pixels, dev, cap: int = 64) -> None:
    """The integer rasters and the circles that decide which pixels a
    feature sums, on the card against the CPU, on the segmentation's own
    labels: texture's gray levels, the radial distribution's most interior
    pixel, rings and wedges (pixels on the 8 rays sit exactly on a wedge
    edge), and the minimum enclosing circle. All must have the same bits."""
    from aliby_tpu_torch.extract import reductions, texture
    from aliby_tpu_torch.ops.edt import edt_to_other_label

    labels = torch.from_numpy(np.concatenate([np.stack(m) for m in seg_labels]).astype(np.int32))
    img = torch.from_numpy(np.concatenate([pixels[:, 1, 0]] * len(seg_labels)))
    got = {}
    for d in (torch.device("cpu"), dev):
        lab, im = labels.to(d), img.to(d)
        _, ring, wedge = texture._rings_and_wedges(lab, cap, 4, 8)
        first = texture._most_interior_pixel(lab, edt_to_other_label(lab), cap)
        present = reductions.counts(lab, cap) > 0
        circle = torch.stack(reductions.minimum_enclosing_circle(lab, cap))
        zero = torch.zeros((), dtype=torch.int32, device=d)
        got[d.type] = [torch.where(lab > 0, a, zero).cpu()
                       for a in (texture.quantize(lab, im, cap), ring, wedge)]
        got[d.type] += [torch.where(present, first, 0).cpu(),
                        torch.where(present, circle, torch.zeros((), device=d)).cpu()]
    names = ("gray levels", "rings", "wedges", "most interior pixel", "minimum enclosing circle")
    for name, c, g in zip(names, got["cpu"], got["cuda"]):
        if not torch.equal(c, g):
            raise AssertionError(f"{name}: the card and the CPU differ on "
                                 f"{int((c != g).sum())} of {c.numel()} values")
    n_obj = int((got["cpu"][4][2] > 0).sum())
    log(f"[rasters] {tuple(labels.shape)} label maps, {n_obj} objects: " + ", ".join(names)
        + " have the same bits on the card and the CPU")


def segment_sum_row(rng, dev, launches: int) -> dict:
    """``segment_sum_matmul`` at the shape the JAX package verifies it at.
    ``launches`` is its counter as read after the default-bank step's
    counted run (no production path calls it, so that run leaves it at 0)."""
    from aliby_tpu_torch.ops import segsum

    N, K, max_labels = SEGMENT_SUM_SHAPE
    v, lab = segment_sum_inputs(rng, N, K, max_labels, dev)
    check_kernel_order(lambda: segsum.segment_sum_matmul(v, lab, max_labels),
                       lambda: segsum.segment_sum_matmul_chunked(v.cpu(), lab.cpu(), max_labels),
                       "segment_sum_matmul (phase 4)")
    valid = (lab >= 1) & (lab <= max_labels)
    idx = torch.where(valid, lab - 1, max_labels).to(torch.int64)
    acc = torch.zeros(max_labels + 1, K, device=dev)
    got = segsum.segment_sum_matmul(v, lab, max_labels)
    want = segsum.segment_sum_matmul_plain(v, lab, max_labels)
    rel, ratio = check_segment_sums(got, want, v, lab, max_labels, "phase 4")
    t_bytes = (N * (K + 1) * 4 + max_labels * K * 4) / PEAK_BYTES_S * 1e3
    t_ops = N * K / PEAK_F32_OPS_S * 1e3
    r = {
        "name": "segment_sum_matmul", "route": "cuda",
        "source": "aliby_tpu_torch/kernels/csrc/segsum.cu",
        "replaces": REPLACES["segment_sum_matmul"], "launches": launches,
        "max_abs_err": max_abs_err(got, want), "max_rel_err": rel, "max_err_over_bound": ratio,
        "ms": cuda_ms(lambda: segsum.segment_sum_matmul(v, lab, max_labels)),
        "plain_ms": cuda_ms(lambda: segsum.segment_sum_matmul_plain(v, lab, max_labels)),
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": cuda_ms(lambda: acc.index_add(0, idx, v)), "shape": [N, K, max_labels],
        "note": "no production path calls it, here as in the JAX package; phases 2 and 4 run it",
    }
    log(f"[report] segment_sum_matmul {(N, K, max_labels)}: kernel {r['ms']:.4f} ms, plain "
        f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}), max abs err {r['max_abs_err']}, max rel err {rel:.3g}, max err / "
        f"bound {ratio:.3g}, launches on the path {launches} (no path calls it)")
    return r


RUNNER_SIZE, RUNNER_TPS, RUNNER_POS, RUNNER_CHUNK = 1080, 3, 2, 2
TRACKER_ROW = "binned_sum_cols_batched (stitch_pair intersection count)"
MAIN_KERNELS = ("successor_prop", "diffuse_heat", "binned_sum_cols_batched",
                "binned_minmax_batched", "table_lookup_batched")


def main_wrappers() -> dict:
    """The wrappers of kernels 1-5 (the main path's), by name."""
    from aliby_tpu_torch.ops import segsum, stencil

    return {"successor_prop": stencil.successor_prop, "diffuse_heat": stencil.diffuse_heat,
            "binned_sum_cols_batched": segsum.binned_sum_cols_batched,
            "binned_minmax_batched": segsum.binned_minmax_batched,
            "table_lookup_batched": segsum.table_lookup_batched}


def mesh_call_recorders(kind=Recorder) -> dict:
    """Recorders (of class ``kind``) of the first call of kernels 1-5 in a
    fused mesh call: the stencils, the flow-error QC's sums (3 columns, 257
    bins), the first min/max and lookup."""
    from aliby_tpu_torch.extract import reductions
    from aliby_tpu_torch.models import flows

    return {"successor_prop": kind(flows, "successor_prop"),
            "diffuse_heat": kind(flows, "diffuse_heat"),
            "binned_sum_cols_batched": kind(reductions, "binned_sum_cols_batched",
                                            lambda v, b, n: n == 257 and v.shape[-1] == 3),
            "binned_minmax_batched": kind(reductions, "binned_minmax_batched"),
            "table_lookup_batched": kind(reductions, "table_lookup_batched")}


def runner_pipeline(ntps: int) -> dict:
    """Phase 5's pipeline: the default bank, a stitch tracker per object,
    mono tile, compiled, the segment and tracker steps saved."""
    from aliby_tpu_torch.engine.builders import build_pipeline_steps

    pipeline = build_pipeline_steps(**DEFAULT_BANK)
    objects = list(DEFAULT_BANK["channels_to_segment"])
    for obj in objects:
        pipeline["steps"][f"track_{obj}"] = {"kind": "stitch", "max_labels": 256,
                                             "iou_threshold": 0.25}
        pipeline["passed_data"][f"track_{obj}"] = [("masks", f"segment_{obj}")]
    pipeline["save"] = [f"{k}_{o}" for k in ("segment", "track") for o in objects]
    pipeline.update(ntps=ntps, compiled=True)
    return pipeline


def same_columns(a: dict, b: dict) -> bool:
    """Two profiles' numpy columns: the same names in the same order, the
    same values (NaN equal to NaN), the same missing entries."""
    if list(a) != list(b):
        return False
    for k in a:
        x, y = np.ma.getdata(a[k]), np.ma.getdata(b[k])
        if x.dtype != y.dtype or x.shape != y.shape or not np.array_equal(
                np.ma.getmaskarray(a[k]), np.ma.getmaskarray(b[k])):
            return False
        if not (np.array_equal(x, y, equal_nan=True) if x.dtype.kind == "f"
                else np.array_equal(x, y)):
            return False
    return True


def same_saves(a: str, b: str) -> int:
    """Every .npz under ``a`` equals its twin under ``b``; returns the count."""
    from pathlib import Path

    files = sorted(p.relative_to(a) for p in Path(a).rglob("*.npz"))
    if not files or files != sorted(p.relative_to(b) for p in Path(b).rglob("*.npz")):
        raise AssertionError(f"saved files differ: {len(files)} under {a}")
    for f in files:
        with np.load(Path(a) / f) as x, np.load(Path(b) / f) as y:
            if sorted(x.keys()) != sorted(y.keys()) or any(
                    x[k].dtype != y[k].dtype or not np.array_equal(x[k], y[k]) for k in x.keys()):
                raise AssertionError(f"saved {f} differs between runs")
    return len(files)


def same_tracker_states(a: dict, b: dict, tracker: str) -> bool:
    sa, sb = a["data"][tracker], b["data"][tracker]
    return len(sa) == len(sb) and all(
        x["max_label"] == y["max_label"] and all(
            np.array_equal(u, v) for u, v in zip(x["labels"], y["labels"]))
        for x, y in zip(sa, sb))


def runner_phase(dev, size=RUNNER_SIZE, ntps=RUNNER_TPS, n_pos=RUNNER_POS,
                 chunk=RUNNER_CHUNK) -> dict:
    """Phase 5: the runner on the card. ``n_pos`` positions x ``ntps``
    timepoints of ``cellpainting_movie`` in a zarr directory store, found by
    ``DatasetZarr``, through (a) the per-tp path, (b) the movie path with
    ``chunk``-timepoint chunks (a ragged tail) and (c) the mesh path over
    every position; returns the kernel row of the tracker's intersection
    count."""
    import tempfile

    from aliby_tpu_torch.engine.compiled import FIELD_BYTES_PER_PIXEL, CompiledStep, try_compile
    from aliby_tpu_torch.engine.core import profile_columns, run_pipeline_return_state
    from aliby_tpu_torch.io import zarrlite
    from aliby_tpu_torch.io.dataset import DatasetZarr
    from aliby_tpu_torch.ops import segsum
    from aliby_tpu_torch.parallel.pipeline_mesh import plan_calls, run_positions_mesh_states
    from aliby_tpu_torch.parallel.positions import stamp_image_kwargs
    from aliby_tpu_torch.pipe import init_step
    from aliby_tpu_torch.test_data import cellpainting_movie
    from aliby_tpu_torch.track import trackers

    wrappers = main_wrappers()
    t0 = time.perf_counter()
    movie = cellpainting_movie(n_pos, ntps, size, seed=13)
    tmp = tempfile.TemporaryDirectory(prefix="aliby_runner_")
    store = os.path.join(tmp.name, "plate.zarr")
    for p in range(n_pos):
        zarrlite.write_array(os.path.join(store, f"pos{p}"), movie[p],
                             chunks=(1, 1, 1, size, size), compressor="zlib")
    positions = DatasetZarr(store).get_position_ids()
    log(f"[runner] {n_pos} positions x {ntps} tps x 5 channels x 1 z x {size}^2 uint16 written "
        f"to a zlib zarr store in {time.perf_counter() - t0:.1f} s; positions "
        f"{[p['key'] for p in positions]}")
    base = runner_pipeline(ntps)
    trackers_ = [n for n in base["steps"] if n.startswith("track")]

    # the tracking of a chunk never waits on the host: the runner's own
    # track_chunk calls run under the sync debug mode "error"; the sum
    # kernel's launches inside each call (the intersection counts: nothing
    # else in tracking sums) are counted per chunk while "launches" is a list
    guarded = {"calls": 0, "launches": None}
    track_chunk = CompiledStep.track_chunk
    sums = segsum.binned_sum_cols_batched

    def no_sync_track_chunk(*a, **kw):
        guarded["calls"] += 1
        before = sums.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            return track_chunk(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            if guarded["launches"] is not None:
                guarded["launches"].append(sums.launches - before)

    # the trackers' intersection counts (stitch_pair's, 257^2 bins)
    counts = Recorder(trackers, "binned_sum_cols_batched", lambda v, b, n: n == 257 * 257)

    def run(what, fn):
        for w in wrappers.values():
            w.launches = 0
        sync()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = fn()
        sync()
        t = time.perf_counter() - t
        launches = {k: w.launches for k, w in wrappers.items()}
        missing = [k for k, n in launches.items() if n <= 0]
        if missing:
            raise AssertionError(f"runner {what}: kernels {missing} not launched ({launches})")
        gb = torch.cuda.max_memory_allocated() / 1e9
        log(f"[runner] {what}: {n_pos * ntps} field-tps in {t:.2f} s = "
            f"{n_pos * ntps / t:.3f} field-tps/s ({t / (n_pos * ntps) * 1e3:.1f} ms a field-tp), "
            f"peak device memory {gb:.3f} GB; launches {launches}")
        return out, {"s": t, "field_tps_per_s": n_pos * ntps / t, "peak_gb": gb,
                     "launches": launches}

    def per_position(movie_mode, tag):
        states = []
        for pos in positions:
            pipe = stamp_image_kwargs(base, pos, capture_order="TCZYX")
            pipe["movie"] = movie_mode
            if movie_mode:
                pipe["movie_chunk"] = chunk
            states.append((pipe, run_pipeline_return_state(
                pipe, os.path.join(tmp.name, tag, pos["key"]), init_step, device=dev)))
        return states

    stats = {}
    (a_states, stats["per_tp"]) = run("(a) per-tp path", lambda: per_position(False, "a"))
    lmax = max(int(np.max(m)) for _, st in a_states for seg in ("segment_nuclei", "segment_cell")
               for m in st["data"][seg])
    state, want = try_compile(base, device=dev).fused.state, {"cap": 256, "u8": lmax <= 255}
    if not 64 < lmax or state != want:
        raise AssertionError(f"the runner's fused step: state {state}, want {want} (largest "
                             f"label {lmax}): the sticky wide pass")
    log(f"[runner] the fused step's sticky wide pass: largest label {lmax}, state {state}")
    CompiledStep.track_chunk = no_sync_track_chunk
    try:
        (b_states, stats["movie"]) = run(f"(b) movie path, chunk {chunk}",
                                         lambda: per_position(True, "b"))
        os.environ["ALIBY_MESH_TIMING"] = "1"
        guarded["launches"] = []
        with counts:
            (mesh, stats["mesh"]) = run(f"(c) mesh path, {n_pos} positions, chunk {chunk}",
                                        lambda: run_positions_mesh_states(
                                            base, positions, os.path.join(tmp.name, "c"),
                                            capture_order="TCZYX", device=dev, chunk=chunk))
    finally:
        CompiledStep.track_chunk = track_chunk
        os.environ.pop("ALIBY_MESH_TIMING", None)
    count_launches, guarded["launches"] = guarded["launches"], None
    if len(count_launches) != -(-ntps // chunk) or min(count_launches) <= 0:
        raise AssertionError(f"the mesh's chunks launched the intersection count "
                             f"{count_launches} times")
    if guarded["calls"] < 2 * -(-ntps // chunk):
        raise AssertionError(f"track_chunk ran {guarded['calls']} times under the sync guard")
    log(f"[runner] chunk tracking: {guarded['calls']} track_chunk calls (movie and mesh) under "
        f"torch.cuda.set_sync_debug_mode('error'): no host synchronisation")
    # a plate that does not fit one call runs in groups of positions
    step = try_compile(base, device=dev)
    fit = step.max_fields(size * size)
    plate = 24
    groups, tps_a_call = plan_calls(plate, 1, ntps, None, fit, step.movie_capable())
    need = fit * FIELD_BYTES_PER_PIXEL * size * size * len(step.seg_names)
    if need > torch.cuda.get_device_properties(dev).total_memory or groups >= plate:
        raise AssertionError(f"{fit} fields of {size}^2 a call: {plate} positions run in "
                             f"groups of {groups}")
    log(f"[runner] the card holds {fit} fields of {size}^2 a fused call (free memory now); a "
        f"plate of {plate} positions x {ntps} tps runs in groups of {groups} positions, "
        f"{tps_a_call} tp a call")
    entries, timing = mesh
    log("[runner] ALIBY_MESH_TIMING split (the mesh's dispatch thread, blocking; finalize not "
        "run: no parquet on the card): " + " ".join(f"{k}={v:.3f}s" for k, v in timing.items()))

    # (a) == (b) == (c): profiles, tracker states, saves
    n_cols = n_saves = 0
    for i, pos in enumerate(positions):
        key = pos["key"]
        pa_, sa = a_states[i]
        cols = profile_columns(sa, pa_)
        for what, (pipe, st) in (("movie", b_states[i]),
                                 ("mesh", (entries[i]["pipeline"], entries[i]["state"]))):
            if not same_columns(profile_columns(st, pipe), cols):
                raise AssertionError(f"{key}: profile columns of the {what} path != per-tp")
            for tr in trackers_:
                if not same_tracker_states(st, sa, tr):
                    raise AssertionError(f"{key}: {tr} states of the {what} path != per-tp")
        n_saves += same_saves(os.path.join(tmp.name, "a", key), os.path.join(tmp.name, "b", key))
        n_saves += same_saves(os.path.join(tmp.name, "a", key),
                              os.path.join(tmp.name, "c", "steps", key))
        n_cols = len(cols)
        if not len(cols.get("metadata_tile", ())):
            raise AssertionError(f"{key}: no profile rows")
    # the card's tracks against the CPU's stitch_movie on the card's own labels
    for i, pos in enumerate(positions):
        pipe, st = a_states[i]
        for tr in trackers_:
            seg = pipe["passed_data"][tr][0][1]
            labels = np.stack([np.stack(m) for m in st["data"][seg]]).astype(np.int32)
            F = labels.shape[1]
            kw = {k: pipe["steps"][tr][k] for k in ("max_labels", "iou_threshold")}
            g, m = trackers.stitch_movie(torch.from_numpy(labels),
                                         torch.zeros(labels.shape[1:], dtype=torch.int32),
                                         torch.zeros(F, dtype=torch.int32), False, **kw)
            for t, state in enumerate(st["data"][tr]):
                if state["max_label"] != m[t].tolist() or not all(
                        np.array_equal(state["labels"][f], g[t, f].numpy()) for f in range(F)):
                    raise AssertionError(f"{pos['key']} {tr} tp {t}: card tracks != CPU "
                                         f"stitch_movie")
                first = int(labels[0].max())
                if min(state["max_label"]) < first:
                    raise AssertionError(f"{pos['key']} {tr} tp {t}: largest global label "
                                         f"{state['max_label']} < frame 0's {first} objects")
            log(f"[runner] {pos['key']} {tr}: frame-0 objects {int(labels[0].max())}, largest "
                f"global label after each tp {m[:, 0].tolist()}; card == CPU stitch_movie")
    log(f"[runner] per-tp == movie == mesh: {n_cols} profile columns per position (NaN equal), "
        f"tracker states and {n_saves} saved .npz identical; card tracks == CPU stitch_movie on "
        f"the card's labels")

    # the device's idle share over a short window of the per-tp and mesh paths,
    # from the card's activity alone (the host's op events of such windows,
    # ~170k and ~80k kernels at chunks of 3, are slow to process)
    short = runner_pipeline(chunk)
    pipe0 = stamp_image_kwargs(short, positions[0], capture_order="TCZYX")
    pipe0["movie"] = False
    idle = {
        "per_tp": device_share(lambda: run_pipeline_return_state(
            pipe0, os.path.join(tmp.name, "p"), init_step, device=dev),
            f"the per-tp path, 1 position x {chunk} tps", host_ops=False),
        "mesh": device_share(lambda: run_positions_mesh_states(
            short, positions, os.path.join(tmp.name, "q"), capture_order="TCZYX", device=dev,
            chunk=chunk), f"the mesh path, one chunk of {n_pos} positions x {chunk} tps",
            host_ops=False),
    }

    # one chunk's tracking and one stitch_pair batch, timed on the mesh's inputs
    ones, bins, n_bins = counts.args
    B = bins.shape[0]
    labels_dev = torch.from_numpy(np.stack(
        [np.stack([np.stack(entries[p]["state"]["data"]["segment_nuclei"][t])[0]
                   for p in range(n_pos)]) for t in range(chunk)]).astype(np.int32)).to(dev)
    zeros = torch.zeros(labels_dev.shape[1:], dtype=torch.int32, device=dev)
    zmax = torch.zeros(labels_dev.shape[1], dtype=torch.int32, device=dev)
    movie_ms = cuda_ms(lambda: trackers.stitch_movie(labels_dev, zeros, zmax, True), reps=7)
    pair_ms = cuda_ms(lambda: trackers.stitch_pair(labels_dev[0], labels_dev[1], zmax), reps=7)
    log(f"[runner] one stitch_movie chunk ({chunk} tps x {labels_dev.shape[1]} fields of "
        f"{size}^2, {chunk} intersection counts): {movie_ms:.3f} ms; one stitch_pair batch "
        f"({labels_dev.shape[1]} fields): {pair_ms:.3f} ms (CUDA events, median of 7)")
    log(f"[report] the trackers' intersection count (one stitch_pair's, {B} fields of {size}^2 "
        f"-> {n_bins} bins; launches counted in the mesh path's track_chunk calls: "
        f"{count_launches} in its {len(count_launches)} chunks, {sum(count_launches)} in all):")
    row = binned_sum_row(ones, bins, n_bins, sum(count_launches), name=TRACKER_ROW)
    row.update(launches_per_chunk=count_launches, runner=stats, stitch_movie_chunk_ms=movie_ms,
               stitch_pair_ms=pair_ms, mesh_timing_s=timing, runner_device_share=idle)
    tmp.cleanup()
    return row



# ------------------------------------------------------------------ phase 6
YEAST_SIZE, YEAST_TPS, YEAST_TILE, YEAST_CPU_TPS, CELLPOSE_TPS = 1024, 5, 117, 2, 3
YEAST_KERNELS = ("binned_sum_cols_batched", "binned_minmax_batched", "table_lookup_batched")
VIRTUAL = " (BABY virtual tiles)"


def yeast_pipeline(store: str, ntps: int, extract: bool = True) -> dict:
    """Example 03's BABY pipeline on trap tiles: threshold base (scale 0.6),
    3 layers, drift tracking on, channel 1 segmented; the tree is the BABY
    default (intensity, sizeshape on channels 1 and 2) plus every cellfuns,
    trap and localisation metric and a channel ratio (every plan entry)."""
    from aliby_tpu_torch.extract.cellfuns import MASK_METRICS, PIXEL_METRICS, TRAP_METRICS
    from aliby_tpu_torch.pipe_builder_baby import build_pipeline_steps

    p = build_pipeline_steps(channels_to_segment={"cell": 1}, channels_to_extract=[1, 2],
                             features_to_extract=("intensity", "sizeshape"),
                             tile_size=YEAST_TILE, base_kind="threshold", threshold_scale=0.6)
    p["steps"]["tile"]["image_kwargs"] = {"source": {"key": "pos1", "path": store},
                                          "capture_order": "TCZYX"}
    p["steps"]["tile"]["track_drift"] = True
    tree = p["steps"]["extract_cell"]["tree"]
    tree["None"]["None"] = tuple(tree["None"]["None"]) + MASK_METRICS
    extra = PIXEL_METRICS + TRAP_METRICS + ("nuc_est_conv", "small_peaks_conv")
    for c in (1, 2):
        tree[c]["max"] = tuple(tree[c]["max"]) + extra
    tree[(1, 2)] = {"div": {"max": ("mean", "median")}}
    if not extract:
        del p["steps"]["extract_cell"], p["passed_data"]["extract_cell"]
    p.update(ntps=ntps, save=[])
    return p


def yeast_outputs(state: dict, pipeline: dict) -> dict:
    from aliby_tpu_torch.engine.core import profile_columns
    from aliby_tpu_torch.pipe_baby import tracking_columns

    tiler = state["fn"]["tile"]
    return {"centres": tiler.tile_locs.initial_centres.copy(),
            "drifts": np.asarray(tiler.tile_locs.drifts),
            "masks": [np.stack(r["masks"]) for r in state["data"]["segment_cell"]],
            "tracking": tracking_columns(state, pipeline).get("segment_cell", {}),
            "profiles": profile_columns(state, pipeline) if "extract_cell" in pipeline["steps"]
            else {}}


def same_yeast(a: dict, b: dict, n_tps: int, what: str) -> None:
    """Tiles, layered masks and tracking/lineage columns of the first
    ``n_tps`` tps identical."""
    if not (np.array_equal(a["centres"], b["centres"])
            and np.array_equal(a["drifts"][:n_tps], b["drifts"][:n_tps])):
        raise AssertionError(f"{what}: trap centres or drifts differ")
    for t in range(n_tps):
        if not np.array_equal(a["masks"][t], b["masks"][t]):
            n = int((a["masks"][t] != b["masks"][t]).sum())
            raise AssertionError(f"{what}: layered masks differ at tp {t} ({n} pixels)")
    rows = lambda c: c["timepoint"] < n_tps  # noqa: E731
    ta, tb = a["tracking"], b["tracking"]
    if list(ta) != list(tb) or any(not np.array_equal(ta[k][rows(ta)], tb[k][rows(tb)])
                                   for k in ta):
        raise AssertionError(f"{what}: tracking/lineage columns differ")


def compare_yeast_profiles(got: dict, want: dict, n_tps: int, what: str) -> int:
    """Card profiles against the CPU's over the first ``n_tps`` tps: the
    same columns and rows, metadata and integer columns exact, features
    within ``extract.tolerances``; returns the number of values compared."""
    from aliby_tpu_torch.extract.tolerances import INTEGER_VALUED, beyond_tolerance

    if list(got) != list(want):
        raise AssertionError(f"{what}: profile column names differ")
    g_rows = np.asarray(got["metadata_tp"]) < n_tps
    w_rows = np.asarray(want["metadata_tp"]) < n_tps
    n = 0
    for name in want:
        g, w = np.asarray(got[name])[g_rows], np.asarray(want[name])[w_rows]
        if name.startswith("metadata_") or g.dtype.kind != "f":
            if g.tolist() != w.tolist():
                raise AssertionError(f"{what}: {name} differs")
            continue
        branch, feat = name.rsplit("/", 1)

        def ref(other, branch=branch, w=w):
            col = want.get(f"{branch}/{other}")
            return w if col is None else np.asarray(col)[w_rows].astype(np.float64)

        bad = beyond_tolerance(feat, g, w, ref)
        if feat in INTEGER_VALUED and not np.array_equal(g, w, equal_nan=True):
            raise AssertionError(f"{what}: integer column {name} differs")
        if bad.any():
            raise AssertionError(f"{what}: {name}: {int(bad.sum())} values beyond tolerance "
                                 f"({g[bad][:3]} vs {w[bad][:3]})")
        n += g.size
    return n


def virtual_tile_rows(recs: dict, launches: dict) -> dict:
    """Kernels 3-5 held to their plain versions and timed at the overlap
    path's virtual-tile shape (every (trap, layer) one image, empty layers
    among them), recorded from the BABY card run."""
    from aliby_tpu_torch.ops import segsum

    out = {}
    vals, bins, n_bins = recs["binned_sum_cols_batched"]
    empty = int((bins.reshape(bins.shape[0], -1).amax(dim=1) == 0).sum())
    log(f"[yeast] virtual-tile shape {tuple(bins.shape)}: {empty} of {bins.shape[0]} "
        f"layers empty")
    if empty == 0:
        raise AssertionError("the recorded virtual tiles hold no empty layer")
    out["binned_sum_cols_batched" + VIRTUAL] = binned_sum_row(
        vals, bins, n_bins, launches["binned_sum_cols_batched"],
        name="binned_sum_cols_batched" + VIRTUAL)
    vals, bins, n_bins = recs["binned_minmax_batched"]
    Bv, K = bins.shape[0], vals.shape[-1]
    N = bins[0].numel()
    idx = segsum._flat_index(bins.reshape(Bv, -1), n_bins).unsqueeze(1).expand(-1, K)
    flat_vals = vals.reshape(-1, K).to(torch.float32)
    mn0 = torch.full((Bv * n_bins + 1, K), float("inf"), device=vals.device)
    mx0 = torch.full((Bv * n_bins + 1, K), float("-inf"), device=vals.device)
    out["binned_minmax_batched" + VIRTUAL] = kernel_row(
        "binned_minmax_batched" + VIRTUAL,
        lambda: segsum.binned_minmax_batched(vals, bins, n_bins),
        lambda: segsum.binned_minmax_batched_plain(vals, bins, n_bins),
        lambda: (mn0.scatter_reduce(0, idx, flat_vals, "amin"),
                 mx0.scatter_reduce(0, idx, flat_vals, "amax")),
        bytes_=Bv * N * (4 * K + 4) + 2 * Bv * n_bins * K * 4, ops=2 * Bv * N * K,
        shape=(Bv, N, K, n_bins), launches=launches["binned_minmax_batched"])
    table, bins = recs["table_lookup_batched"]
    Bt, L, K = table.shape
    N = bins[0].numel()
    flat_tab = table.reshape(Bt * L, K)
    fidx = (bins.reshape(Bt, -1).clamp(0, L - 1).to(torch.int64)
            + torch.arange(Bt, device=bins.device)[:, None] * L).reshape(-1)
    out["table_lookup_batched" + VIRTUAL] = kernel_row(
        "table_lookup_batched" + VIRTUAL,
        lambda: segsum.table_lookup_batched(table, bins),
        lambda: segsum.table_lookup_batched_plain(table, bins), lambda: flat_tab[fidx],
        bytes_=Bt * N * 4 + Bt * N * K * 4 + Bt * L * K * 4, ops=0, shape=(Bt, N, L, K),
        launches=launches["table_lookup_batched"])
    return out


class StageTimer:
    """Wraps a module attribute to add up the wall time of its calls (the
    card synchronised before and after each)."""

    def __init__(self, module, name):
        self.module, self.name, self.s, self.calls = module, name, 0.0, 0

    def __call__(self, *args, **kwargs):
        sync()
        t0 = time.perf_counter()
        try:
            return self.fn(*args, **kwargs)
        finally:
            sync()
            self.s += time.perf_counter() - t0
            self.calls += 1

    def __enter__(self):
        self.fn = getattr(self.module, self.name)
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def yeast_phase(dev) -> dict:
    """Phase 6: the yeast time-lapse path (example 03 on trap tiles).
    Returns the kernel rows of kernels 3-5 at the virtual-tile shape."""
    import functools
    import tempfile

    from aliby_tpu_torch.engine import core
    from aliby_tpu_torch.extract import reductions
    from aliby_tpu_torch.io import zarrlite
    from aliby_tpu_torch.models import baby, segment
    from aliby_tpu_torch.ops import segsum, stencil
    from aliby_tpu_torch.pipe import init_step
    from aliby_tpu_torch.pipe_baby import init_step as baby_init_step
    from aliby_tpu_torch.test_data import yeast_trap_movie
    from aliby_tpu_torch.tile.traps import segment_traps
    from aliby_tpu_torch.track import trackers

    t0 = time.perf_counter()
    movie, truth = yeast_trap_movie(T=YEAST_TPS, size=YEAST_SIZE, seed=17)
    tmp = tempfile.TemporaryDirectory(prefix="aliby_yeast_")
    store = os.path.join(tmp.name, "pos1")
    zarrlite.write_array(store, movie, chunks=(1, 1, 1, YEAST_SIZE, YEAST_SIZE),
                         compressor="zlib")
    log(f"[yeast] 1 position x {YEAST_TPS} tps x 3 channels x 3 z x {YEAST_SIZE}^2 uint16 "
        f"({len(truth)} interior traps rendered) written to a zlib zarr store in "
        f"{time.perf_counter() - t0:.1f} s")

    # (a) trap detection on the card and on the CPU
    frame = movie[0, 0, 0].astype(np.float32)
    with torch.no_grad():
        segment_traps(frame, YEAST_TILE, device=dev)  # warm-up (cuFFT plans)
        sync()
        t0 = time.perf_counter()
        card = segment_traps(frame, YEAST_TILE, device=dev)
        sync()
        t_card = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu = segment_traps(frame, YEAST_TILE, device="cpu")
        t_cpu = time.perf_counter() - t0
    if len(card) != len(cpu):
        raise AssertionError(f"(a) trap counts differ: card {len(card)}, CPU {len(cpu)}")
    # each card centre's distance (in either axis) to the nearest CPU centre
    off = np.abs(card[:, None, :].astype(np.int64) - cpu[None, :, :]).max(axis=2).min(axis=1)
    if off.max() > 1:
        raise AssertionError(f"(a) a trap centre is {off.max()} px from the CPU's")
    if len(card) < 0.9 * len(truth):
        raise AssertionError(f"(a) {len(card)} traps found of {len(truth)}")
    log(f"[yeast] (a) trap detection at tile {YEAST_TILE}: {len(card)} traps ({len(truth)} "
        f"rendered), centres within {int(off.max())} px of the CPU's "
        f"({int((off == 0).sum())} equal); card {t_card * 1e3:.1f} ms, "
        f"CPU {t_cpu * 1e3:.1f} ms")

    # (b) the BABY path through the state path
    wrappers = {"binned_sum_cols_batched": segsum.binned_sum_cols_batched,
                "binned_minmax_batched": segsum.binned_minmax_batched,
                "table_lookup_batched": segsum.table_lookup_batched}
    pipe = yeast_pipeline(store, YEAST_TPS)

    def run_baby(device, pipeline):
        return core.run_pipeline_return_state(pipeline, None, baby_init_step, device=device)

    virtual = lambda v, b, *rest: b.dim() == 3 and b.shape[0] > len(card) \
        and tuple(b.shape[1:]) == (YEAST_TILE, YEAST_TILE)  # noqa: E731
    recs = {name: Recorder(reductions, name, virtual) for name in YEAST_KERNELS}
    for w in wrappers.values():
        w.launches = 0
    sync()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with recording(recs.values()):
        state1 = run_baby(dev, pipe)
    sync()
    t_run1 = time.perf_counter() - t0
    gb = torch.cuda.max_memory_allocated() / 1e9
    launches = {k: w.launches for k, w in wrappers.items()}
    if min(launches.values()) <= 0:
        raise AssertionError(f"(b) kernels not launched on the BABY path: {launches}")
    out1 = yeast_outputs(state1, pipe)
    n_tiles = state1["fn"]["tile"].n_tiles
    log(f"[yeast] (b) BABY path on the card: {YEAST_TPS} tps x {n_tiles} trap tiles in "
        f"{t_run1:.2f} s ({t_run1 / YEAST_TPS * 1e3:.1f} ms a tp, trap detection included); "
        f"peak device memory {gb:.3f} GB; launches {launches}")
    with StageTimer(segment, "threshold_segment") as seg_t, \
            StageTimer(baby, "stitch_rois") as trk_t:
        t0 = time.perf_counter()
        state2 = run_baby(dev, pipe)
        sync()
        t_run2 = time.perf_counter() - t0
    out2 = yeast_outputs(state2, pipe)
    same_yeast(out1, out2, YEAST_TPS, "(b) two card runs")
    if not same_columns(out1["profiles"], out2["profiles"]):
        raise AssertionError("(b) two card runs: profile columns differ")
    timer = state2["timer"].summary()
    seg_total = timer["segment_cell"]["total_s"]
    stages = {"tiling_s": timer["tile"]["total_s"], "segmentation_s": seg_t.s,
              "tracking_s": trk_t.s, "baby_bookkeeping_s": seg_total - seg_t.s - trk_t.s,
              "extraction_s": timer["extract_cell"]["total_s"]}
    n_rows = len(out1["profiles"]["metadata_tile"])
    n_mothers = int((out1["tracking"]["mother_label"] > 0).sum())
    log(f"[yeast] (b) two card runs identical: layered masks, tracking/lineage "
        f"({len(out1['tracking']['tile'])} rows, {n_mothers} with a mother), "
        f"{len(out1['profiles'])} profile columns x {n_rows} rows (NaN equal)")
    log(f"[yeast] (b) second run {t_run2:.2f} s ({t_run2 / YEAST_TPS * 1e3:.1f} ms a tp); stage "
        "split (card synchronised around the segmenter and the tracker): " + ", ".join(
            f"{k} {v:.3f}" for k, v in stages.items()))
    # the device's idle share over one tp (the last), after the others
    short = yeast_pipeline(store, YEAST_TPS - 1)
    state = run_baby(dev, short)
    idle = device_share(lambda: core.pipeline_step(
        short, state, None, functools.partial(baby_init_step, device=dev)),
        f"one BABY tp (tp {YEAST_TPS - 1}) of {n_tiles} trap tiles", warmup=False)

    # the CPU: the whole movie without extraction, then YEAST_CPU_TPS tps with it
    t0 = time.perf_counter()
    with kernel_order_on_cpu():
        seg_only = yeast_pipeline(store, YEAST_TPS, extract=False)
        cpu_seg = yeast_outputs(run_baby("cpu", seg_only), seg_only)
        short = yeast_pipeline(store, YEAST_CPU_TPS)
        cpu_full = yeast_outputs(run_baby("cpu", short), short)
    t_cpu = time.perf_counter() - t0
    same_yeast(out1, cpu_seg, YEAST_TPS, "(b) card vs CPU")
    same_yeast(out1, cpu_full, YEAST_CPU_TPS, "(b) card vs CPU (with extraction)")
    n_vals = compare_yeast_profiles(out1["profiles"], cpu_full["profiles"], YEAST_CPU_TPS,
                                    "(b) card vs CPU")
    log(f"[yeast] (b) card == CPU: trap centres, drifts, layered masks and tracking/lineage "
        f"over {YEAST_TPS} tps; profiles of tps 0-{YEAST_CPU_TPS - 1} within "
        f"extract.tolerances ({n_vals} values; the CPU's sums in the kernel's order); CPU runs "
        f"{t_cpu:.1f} s")

    # (c) cellpose on trap tiles through the compiled runner
    cp = {
        "steps": {
            "tile": {"tile_size": YEAST_TILE, "track_drift": True,
                     "image_kwargs": {"source": {"key": "pos1", "path": store},
                                      "capture_order": "TCZYX"}},
            "segment_cell": {"segmenter_kwargs": {"kind": "cellpose", "min_size": 10},
                             "channel_to_segment": 1},
            "track_cell": {"kind": "stitch", "max_labels": 256, "iou_threshold": 0.25},
            "extract_cell": {"tree": {"None": {"None": ["area"]}, 1: {"max": ["mean"]}},
                             "kwargs": {}},
        },
        "passed_data": {"extract_cell": [("masks", "segment_cell"), ("pixels", "tile")],
                        "track_cell": [("masks", "segment_cell")]},
        "passed_methods": {"segment_cell": ("tile", "get_fczyx")},
        "save": [], "ntps": CELLPOSE_TPS, "compiled": True,
    }
    main = dict(wrappers, successor_prop=stencil.successor_prop, diffuse_heat=stencil.diffuse_heat)
    for w in main.values():
        w.launches = 0
    sync()
    t0 = time.perf_counter()
    st = core.run_pipeline_return_state(cp, None, init_step, device=dev)
    sync()
    t_cp = time.perf_counter() - t0
    cp_launches = {k: w.launches for k, w in main.items()}
    if min(cp_launches.values()) <= 0:
        raise AssertionError(f"(c) kernels not launched: {cp_launches}")
    labels = np.stack([np.stack(m) for m in st["data"]["segment_cell"]]).astype(np.int32)
    F = labels.shape[1]
    if F != st["fn"]["tile"].n_tiles or F < 0.9 * len(truth):
        raise AssertionError(f"(c) {F} fields a tp, {st['fn']['tile'].n_tiles} traps")
    g, m = trackers.stitch_movie(torch.from_numpy(labels),
                                 torch.zeros(labels.shape[1:], dtype=torch.int32),
                                 torch.zeros(F, dtype=torch.int32), False,
                                 max_labels=256, iou_threshold=0.25)
    for t, tr in enumerate(st["data"]["track_cell"]):
        if tr["max_label"] != m[t].tolist() or not all(
                np.array_equal(tr["labels"][f], g[t, f].numpy()) for f in range(F)):
            raise AssertionError(f"(c) tp {t}: card tracks != CPU stitch_movie")
    log(f"[yeast] (c) cellpose on {F} trap tiles, compiled, {CELLPOSE_TPS} tps: {t_cp:.2f} s; "
        f"launches {cp_launches}; objects a tp {[int((labels[t].reshape(F, -1).max(1)).sum()) for t in range(CELLPOSE_TPS)]} "
        f"(sum of per-trap counts); card tracks == CPU stitch_movie on the card's labels")

    # (d) kernels 3-5 at the virtual-tile shape
    for name, r in recs.items():
        if r.args is None:
            raise AssertionError(f"(d) no {name} call at the virtual-tile shape was recorded")
    rows = virtual_tile_rows({k: r.args for k, r in recs.items()}, launches)
    for r in rows.values():
        r.update(yeast={"ms_per_tp": t_run2 / YEAST_TPS * 1e3, "peak_gb": gb,
                        "stages_s": stages, "idle": idle, "traps": len(card),
                        "trap_detection_ms": t_card * 1e3})
    tmp.cleanup()
    return rows



# ------------------------------------------------------------------ phase 7
ZOO_SIZE, ZOO_TPS, ZOO_CHUNK, ZOO_CROP = 1080, 3, 3, 256
EMBED_POS, EMBED_TILE, EMBED_DIM = 4, 64, 64
SPOT_FRAMES = 16
ZOO_MIN_IOU = 0.99  # card vs CPU labels where not bit-equal: equal counts, matched IoU
CPNET_MESH = " (CPnet mesh)"


def zoo_pipeline(checkpoint: str, ntps: int, qc: bool) -> dict:
    """Phase 7 (a): the default bank on a CPnet engine (a torch checkpoint
    at the cyto width), mono tile, compiled, the segment steps saved; the
    flow-error QC on or off."""
    from aliby_tpu_torch.engine.builders import build_pipeline_steps

    seg = {"pretrained_path": checkpoint}
    if not qc:
        seg["flow_threshold"] = None
    pipeline = build_pipeline_steps(**DEFAULT_BANK, segmenter_extra_kwargs=seg)
    pipeline.update(ntps=ntps, compiled=True)
    return pipeline


def labels_of(state: dict, steps) -> np.ndarray:
    """(steps, T, F, Y, X) label maps of a state's segment steps."""
    return np.stack([np.stack([np.stack([np.asarray(m) for m in tp])
                               for tp in state["data"][s]]) for s in steps])


def same_labels_or_iou(got: list, want: list, what: str) -> str:
    """Card vs CPU label maps: bit-equal, or equal object counts and matched
    IoU >= ``ZOO_MIN_IOU`` both ways (the rule for a flow bit that moves a
    pixel across a threshold)."""
    worst, n_equal = 1.0, 0
    for i, (x, y) in enumerate(zip(got, want)):
        if np.array_equal(x, y):
            n_equal += 1
            continue
        iou = min(matched_iou(x, y), matched_iou(y, x)) if x.max() or y.max() else 1.0
        worst = min(worst, iou)
        if x.max() != y.max() or iou < ZOO_MIN_IOU:
            raise AssertionError(f"{what} {i}: card {x.max()} objects, CPU {y.max()}, matched "
                                 f"IoU {iou:.4f}")
    return f"{n_equal}/{len(got)} bit-equal" + ("" if n_equal == len(got)
                                                 else f", worst matched IoU {worst:.6f}")


def zoo_cpnet(dev, tmp, positions, movie, wrappers) -> dict:
    """Phase 7 (a): CPnet through the production runner."""
    from aliby_tpu_torch.engine.core import profile_columns, run_pipeline_return_state
    from aliby_tpu_torch.extract.tolerances import within_model_tolerance
    from aliby_tpu_torch.models.cpnet import load_cellpose_checkpoint
    from aliby_tpu_torch.models.segment import CellposeTorch, _normalize_percentile
    from aliby_tpu_torch.parallel.pipeline_mesh import run_positions_mesh_states
    from aliby_tpu_torch.parallel.positions import stamp_image_kwargs
    from aliby_tpu_torch.pipe import init_step
    from aliby_tpu_torch.test_data import cpnet_state_dict

    checkpoint = os.path.join(tmp, "cyto_seeded.pth")
    torch.save(cpnet_state_dict(0), checkpoint)
    segs = [f"segment_{o}" for o in DEFAULT_BANK["channels_to_segment"]]
    key = positions[0]["key"]
    stats = {}

    def counted(what, fn, required):
        for w in wrappers.values():
            w.launches = 0
        sync()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        out = fn()
        sync()
        t = time.perf_counter() - t
        launches = {k: w.launches for k, w in wrappers.items()}
        missing = [k for k in required if launches[k] <= 0]
        if missing:
            raise AssertionError(f"(a) {what}: kernels {missing} not launched ({launches})")
        gb = torch.cuda.max_memory_allocated() / 1e9
        log(f"[zoo] (a) {what}: {ZOO_TPS} tps in {t:.2f} s ({t / ZOO_TPS * 1e3:.1f} ms a tp), "
            f"peak device memory {gb:.3f} GB; launches {launches}")
        return out, {"s": t, "ms_per_tp": t / ZOO_TPS * 1e3, "peak_gb": gb, "launches": launches}

    def per_position(pipeline, movie_mode, tag):
        pipe = stamp_image_kwargs(pipeline, positions[0], capture_order="TCZYX")
        pipe["movie"] = movie_mode
        if movie_mode:
            pipe["movie_chunk"] = ZOO_CHUNK
        return pipe, run_pipeline_return_state(pipe, os.path.join(tmp, tag, key), init_step,
                                               device=dev)

    def mesh(pipeline, tag):
        entries, _ = run_positions_mesh_states(pipeline, positions, os.path.join(tmp, tag),
                                               capture_order="TCZYX", device=dev,
                                               chunk=ZOO_CHUNK)
        return entries[0]["pipeline"], entries[0]["state"]

    # kernels 1-5 at the mesh call's shapes: the stencils and the QC sums of
    # its 6 images (3 tps x 2 objects), a default-bank min/max and lookup
    recs = mesh_call_recorders()
    runs = {}
    for qc in (True, False):
        tag = "qc" if qc else "noqc"
        base = zoo_pipeline(checkpoint, ZOO_TPS, qc)
        with recording(recs.values() if qc else ()):
            (pipe, st), stats[f"mesh_qc_{'on' if qc else 'off'}"] = counted(
                f"run_positions_mesh, 1 position, QC {'on' if qc else 'off'}",
                lambda: mesh(base, f"c_{tag}"),
                # the flow-error QC alone runs diffuse_heat (masks_to_flows)
                [k for k in wrappers if qc or k != "diffuse_heat"])
        lab = labels_of(st, segs)
        per_field = lab.reshape(len(segs), ZOO_TPS, -1).max(axis=2)
        log(f"[zoo] (a) QC {'on' if qc else 'off'}: labels a field (nuclei, cell; by tp) "
            f"{per_field.tolist()}")
        if not qc and per_field.min() <= 0:
            raise AssertionError(f"(a) a field has no labels with the QC off: {per_field}")
        runs[tag] = (base, pipe, st, lab)
        stats[f"labels_qc_{'on' if qc else 'off'}"] = per_field.tolist()
    base, pipe, st, lab = runs["noqc"]
    cols = profile_columns(st, pipe)
    if not len(cols.get("metadata_tile", ())):
        raise AssertionError("(a) no profile rows")
    t_paths = time.perf_counter()
    for what, (p, s) in (("per-tp", per_position(base, False, "a")),
                         ("movie", per_position(base, True, "b")),
                         ("mesh again", mesh(base, "c_again"))):
        if not np.array_equal(labels_of(s, segs), lab):
            raise AssertionError(f"(a) labels of the {what} path != the mesh's")
        if not same_columns(profile_columns(s, p), cols):
            raise AssertionError(f"(a) profile columns of the {what} path != the mesh's")
    log(f"[zoo] (a) the per-tp, movie and second mesh runs: {time.perf_counter() - t_paths:.1f} s")
    n_saves = same_saves(os.path.join(tmp, "a", key), os.path.join(tmp, "c_noqc", "steps", key))
    n_saves += same_saves(os.path.join(tmp, "b", key), os.path.join(tmp, "c_again", "steps", key))
    log(f"[zoo] (a) per-tp == movie == mesh == mesh again (QC off): labels, {len(cols)} profile "
        f"columns x {len(cols['metadata_tile'])} rows (NaN equal), {n_saves} saved .npz")
    t_idle = time.perf_counter()  # one tp: the profiler's table of ~50k kernels takes long
    stats["idle"] = device_share(lambda: mesh(zoo_pipeline(checkpoint, 1, False), "c_idle"),
                                 f"the CPnet mesh path, 1 tp of {ZOO_SIZE}^2", warmup=False,
                                 host_ops=False)
    log(f"[zoo] (a) the profiled mesh run: {time.perf_counter() - t_idle:.1f} s")

    # the forward alone: f32 (cuDNN TF32 off inside, the caller's flag kept) and bf16
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    field = movie[0, 0, [0, 3], 0].astype(np.float32)  # (2, Y, X): a nuclei and a cell image
    imgs = np.stack([field, np.zeros_like(field)], axis=1)  # (2, 2, Y, X), no second channel
    x = _normalize_percentile(torch.from_numpy(imgs).to(dev).permute(0, 2, 3, 1))[:1]
    f32 = load_cellpose_checkpoint(checkpoint).to(dev)
    bf16 = load_cellpose_checkpoint(checkpoint, dtype=torch.bfloat16).to(dev)
    with torch.no_grad():
        ms_f32, ms_bf16 = cuda_ms_turns([lambda: f32(x), lambda: bf16(x)], reps=7)
    if not torch.backends.cudnn.allow_tf32:
        raise AssertionError("the CPnet forward changed torch.backends.cudnn.allow_tf32")
    torch.backends.cudnn.allow_tf32 = tf32
    stats.update(forward_ms_f32=ms_f32, forward_ms_bf16=ms_bf16)
    log(f"[zoo] (a) CPnet forward at nbase (2, 32, 64, 128, 256), one {ZOO_SIZE}^2 image: f32 "
        f"{ms_f32:.2f} ms, bf16 {ms_bf16:.2f} ms (CUDA events, median of 7)")

    # the card against the CPU on a crop: labels, QC on and off; the f32 forward
    crop = np.ascontiguousarray(imgs[1:, :, :ZOO_CROP, :ZOO_CROP])  # the cell image
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, os.cpu_count() or 1))
    t0 = time.perf_counter()
    for ft in (0.4, None):
        kw = dict(pretrained_path=checkpoint, flow_threshold=ft)
        card = CellposeTorch(device=dev, **kw).segment_tiles(crop)
        cpu = CellposeTorch(device="cpu", **kw).segment_tiles(crop)
        rule = same_labels_or_iou(card, cpu, f"(a) a {ZOO_CROP}^2 crop, QC {ft}, image")
        log(f"[zoo] (a) card vs CPU labels, a {ZOO_CROP}^2 crop, flow_threshold {ft}: objects "
            f"{[int(m.max()) for m in card]}, {rule}")
    xc = _normalize_percentile(torch.from_numpy(crop).permute(0, 2, 3, 1))
    with torch.no_grad():
        out_card, style_card = f32(xc.to(dev))
        out_cpu, style_cpu = load_cellpose_checkpoint(checkpoint)(xc)
    torch.set_num_threads(threads)
    out_card, out_cpu = out_card.cpu().numpy(), out_cpu.numpy()
    err = float(np.abs(out_card - out_cpu).max())
    if not (within_model_tolerance(out_card, out_cpu, "cpnet")
            and within_model_tolerance(style_card.cpu().numpy(), style_cpu.numpy(), "cpnet")):
        raise AssertionError(f"(a) f32 forward, card vs CPU: max abs err {err} (scale "
                             f"{np.abs(out_cpu).max()})")
    stats["forward_card_vs_cpu_max_abs_err"] = err
    log(f"[zoo] (a) f32 forward card vs CPU on the crop: max abs err {err:.3g} of scale "
        f"{np.abs(out_cpu).max():.3g} (within 2e-4 of max(1, scale)); CPU checks "
        f"{time.perf_counter() - t0:.1f} s")

    # f32 forwards on four threads at once, as run_positions' workers and the
    # server's connections run them: each the bits of its run alone, TF32
    # off for all of them, the caller's flag afterwards
    crops = [_normalize_percentile(torch.from_numpy(np.ascontiguousarray(
        imgs[1:, :, r:r + ZOO_CROP, c:c + ZOO_CROP])).permute(0, 2, 3, 1)).to(dev)
        for r in (0, ZOO_CROP) for c in (0, ZOO_CROP)]
    torch.backends.cudnn.allow_tf32 = True
    with torch.no_grad():
        alone = [f32(c)[0] for c in crops]
    outs, errors = {}, []
    start = threading.Barrier(len(crops))

    def forwards(i):
        try:
            start.wait(60)
            for r in range(3):
                with torch.no_grad():
                    outs[i, r] = f32(crops[i])[0]
            torch.cuda.current_stream().synchronize()
        except Exception as e:  # raised below, on the phase's thread
            errors.append(e)

    workers = [threading.Thread(target=forwards, args=(i,)) for i in range(len(crops))]
    for w in workers:
        w.start()
    for w in workers:
        w.join(300)
    if errors:
        raise errors[0]
    if not torch.backends.cudnn.allow_tf32:
        raise AssertionError("(a) f32 forwards on threads left torch.backends.cudnn.allow_tf32 "
                             "changed")
    torch.backends.cudnn.allow_tf32 = tf32
    differ = [k for k, o in outs.items() if not torch.equal(o, alone[k[0]])]
    if len(outs) != 3 * len(crops) or differ:
        raise AssertionError(f"(a) f32 forwards on threads differ from the forward alone: {differ}")
    log(f"[zoo] (a) f32 forwards on {len(crops)} threads at once (3 each, {ZOO_CROP}^2 crops): "
        f"the bits of the forward alone; the caller's TF32 flag kept")

    missing = [k for k, r in recs.items() if r.args is None]
    if missing:
        raise AssertionError(f"(a) no call of {missing} was recorded in the QC-on mesh run")
    log("[report] kernels 1-5 at the CPnet mesh call's shapes (launches: the QC-on mesh run):")
    rows = {}
    for name, row in measure_kernels({k: r.args for k, r in recs.items()},
                                     stats["mesh_qc_on"]["launches"]).items():
        row["name"] = name + CPNET_MESH
        rows[name + CPNET_MESH] = row
    return stats, rows


def example02(store_pos: dict) -> dict:
    from copy import deepcopy

    pipeline = deepcopy({
        "steps": {"tile": {"kind": "crop", "tile_size": EMBED_TILE, "track_drift": False,
                           "standard_scale": True},
                  "embed_cells": {"model": "style", "dim": EMBED_DIM}},
        "passed_data": {"embed_cells": [("pixels", "tile")]},
        "passed_methods": {}, "save": [], "save_interval": 1})
    pipeline["steps"]["tile"]["image_kwargs"] = {
        "source": {"key": store_pos["key"], "path": store_pos["path"]}, "capture_order": "CYX"}
    return pipeline


def zoo_embeddings(dev, tmp) -> dict:
    """Phase 7 (b): example 02 on the card, through the state path."""
    from aliby_tpu_torch.engine.core import profile_columns, run_pipeline_return_state
    from aliby_tpu_torch.extract.tolerances import within_model_tolerance
    from aliby_tpu_torch.io import zarrlite
    from aliby_tpu_torch.io.dataset import DatasetZarr
    from aliby_tpu_torch.pipe import init_step
    from aliby_tpu_torch.test_data import cellpainting_large_field

    store = os.path.join(tmp, "embed.zarr")
    for p in range(EMBED_POS):
        field = cellpainting_large_field(ZOO_SIZE, seed=31 + p)[0, :, 0]  # (C, Y, X)
        zarrlite.write_array(os.path.join(store, f"pos{p}"),
                             np.clip(np.rint(field * 4096), 0, 65535).astype(np.uint16),
                             chunks=(1, ZOO_SIZE, ZOO_SIZE), compressor="zlib")
    positions = DatasetZarr(store).get_position_ids()

    def run(pos, device):
        pipe = example02(pos)
        return profile_columns(run_pipeline_return_state(pipe, None, init_step, device=device),
                               pipe)

    times, cols = [], []
    for pos in positions:
        sync()
        t0 = time.perf_counter()
        cols.append(run(pos, dev))
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    x_cols = [c for c in cols[0] if c.startswith("X_")]
    if len(x_cols) != EMBED_DIM or any(list(c) != list(cols[0]) for c in cols):
        raise AssertionError(f"(b) {len(x_cols)} X columns; column sets differ")
    again = run(positions[0], dev)
    if not same_columns(again, cols[0]):
        raise AssertionError("(b) two card runs of a position differ")
    t0 = time.perf_counter()
    cpu = run(positions[0], "cpu")
    t_cpu = time.perf_counter() - t0
    if [c for c in cpu] != list(cols[0]) or any(
            not np.array_equal(cpu[c], cols[0][c]) for c in cpu if not c.startswith("X_")):
        raise AssertionError("(b) card vs CPU: metadata or column names differ")
    got = np.stack([cols[0][c] for c in x_cols])
    want = np.stack([cpu[c] for c in x_cols])
    diff = np.abs(got - want)
    if not within_model_tolerance(got, want, "embed"):
        raise AssertionError(f"(b) X columns card vs CPU beyond the bf16 embedding rule: max "
                             f"abs err {diff.max()}, mean {diff.mean()}")
    n_rows = len(cols[0]["metadata_tile"])
    log(f"[zoo] (b) example 02: {EMBED_POS} positions x 5 channels x {ZOO_SIZE}^2 (zlib zarr), "
        f"{n_rows} crops of {EMBED_TILE} a position, X_0..X_{EMBED_DIM - 1}: ms a position "
        f"{[round(t, 1) for t in times]} (the first builds the encoder); two card runs the same "
        f"bits; card vs CPU max abs err {diff.max():.3g}, mean {diff.mean():.3g}, of scale "
        f"{np.abs(want).max():.3g} (the bf16 embedding rule); CPU {t_cpu:.1f} s a position")
    return {"ms_per_position": times, "crops": n_rows,
            "card_vs_cpu_max_abs_err": float(diff.max()),
            "card_vs_cpu_mean_abs_err": float(diff.mean())}


def zoo_server(dev, tmp, positions, wrappers) -> dict:
    """Phase 7 (c): a ModelServer on the card, a client pipeline on the host."""
    from aliby_tpu_torch.engine.core import get_step_output, run_pipeline_return_state
    from aliby_tpu_torch.engine.global_steps import dispatch_global_step
    from aliby_tpu_torch.net import wire
    from aliby_tpu_torch.net.server import ModelServer
    from aliby_tpu_torch.parallel.positions import stamp_image_kwargs
    from aliby_tpu_torch.pipe import init_step

    address = f"ipc://{tmp}/zoo.ipc"

    def pipeline(remote: bool) -> dict:
        def seg(kind, ch):
            kw = {"kind": f"nahual_{kind}", "address": address} if remote else {"kind": kind}
            return {"segmenter_kwargs": kw, "channel_to_segment": ch}

        embed = "nahual_embed" if remote else "embed_cells"
        steps = {"tile": {"tile_size": None},
                 "segment_cell": seg("cellpose", 3),
                 "segment_spots": seg("spotiflow" if remote else "spots", 0),
                 embed: ({"address": address, "setup_params": {"dim": EMBED_DIM}} if remote
                         else {"dim": EMBED_DIM})}
        pipe = {"steps": steps, "passed_data": {embed: [("pixels", "tile")]},
                "passed_methods": {"segment_cell": ("tile", "get_fczyx"),
                                   "segment_spots": ("tile", "get_fczyx")},
                "save": [], "ntps": ZOO_TPS}
        return stamp_image_kwargs(pipe, positions[0], capture_order="TCZYX")

    calls = []
    call = wire.Client.call

    def timed_call(self, op, **payload):
        t0 = time.perf_counter()
        result = call(self, op, **payload)
        dt = time.perf_counter() - t0
        calls.append((op, payload.get("model"), dt * 1e3,
                      len(wire._encode({"op": op, **payload})),
                      len(wire._encode({"result": result}))))
        return result

    server = ModelServer(address, device=dev).start()
    wire.Client.call = timed_call
    try:
        for w in wrappers.values():
            w.launches = 0
        sync()
        t0 = time.perf_counter()
        remote = run_pipeline_return_state(pipeline(True), None, init_step, device=dev)
        tracks = dispatch_global_step("nahual_trackastra", address=address)(
            get_step_output(remote["data"], ["segment_cell"]))
        sync()
        t_remote = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
    finally:
        wire.Client.call = call
        server.stop()
    for k in ("successor_prop", "diffuse_heat", "binned_sum_cols_batched"):
        if launches[k] <= 0:
            raise AssertionError(f"(c) {k} was not launched inside the server ({launches})")
    local = run_pipeline_return_state(pipeline(False), None, init_step, device=dev)
    local_tracks = dispatch_global_step("track_global", device=dev)(
        get_step_output(local["data"], ["segment_cell"]))
    for step in ("segment_cell", "segment_spots"):
        got, want = labels_of(remote, [step]), labels_of(local, [step])
        if not np.array_equal(got, want) or got.max() <= 0:
            raise AssertionError(f"(c) {step}: the server's masks != in process (max "
                                 f"{got.max()}, {want.max()})")
    emb_r = np.stack(remote["data"]["nahual_embed"])
    emb_l = np.stack(local["data"]["embed_cells"])
    if emb_r.shape != (ZOO_TPS, 1, EMBED_DIM) or not np.array_equal(emb_r, emb_l):
        raise AssertionError(f"(c) embeddings: the server's != in process ({emb_r.shape})")
    if list(tracks) != list(local_tracks) or any(
            not np.array_equal(tracks[k], local_tracks[k]) for k in tracks) \
            or not len(tracks["track_id"]):
        raise AssertionError("(c) tracks columns: the server's != in process")
    per_op = collections.defaultdict(list)
    for op, model, ms, sent, got in calls:
        per_op[(op, model)].append((ms, sent, got))
    summary = {f"{op} {model}": {"calls": len(v), "ms": statistics.median(x[0] for x in v),
                                 "bytes_sent": statistics.median(x[1] for x in v),
                                 "bytes_received": statistics.median(x[2] for x in v)}
               for (op, model), v in per_op.items()}
    for name, s in summary.items():
        log(f"[zoo] (c) {name}: {s['calls']} calls, round trip {s['ms']:.1f} ms (median), "
            f"{s['bytes_sent']:.0f} bytes sent, {s['bytes_received']:.0f} received a call")
    objects = labels_of(remote, ["segment_cell"]).reshape(ZOO_TPS, -1).max(axis=1).tolist()
    log(f"[zoo] (c) the client pipeline over {ZOO_TPS} tps of {ZOO_SIZE}^2 through the server "
        f"({address}, one thread a connection): {t_remote:.2f} s; launches inside the server "
        f"{launches}; masks (cells {objects} a tp, spots), embeddings and "
        f"{len(tracks['track_id'])} track rows == the same models in process on the card")
    return {"s": t_remote, "launches": launches, "calls": summary}


def zoo_spots(dev, movie) -> dict:
    """Phase 7 (d): the spot detector on 16 frames of 1080^2, card vs CPU."""
    from aliby_tpu_torch.models.spots import detect_spots, paint_spots

    frames = np.concatenate([movie[0, :, c, 0] for c in range(5)]
                            + [movie[0, :1, 0, 0]]).astype(np.float32)[:SPOT_FRAMES]
    x = torch.from_numpy(frames)

    def run(t):
        with torch.no_grad():
            c, r, v = detect_spots(t)
            return c, r, v, paint_spots(tuple(t.shape[1:]), c, r, v)

    card = [a.cpu() for a in run(x.to(dev))]
    ms = cuda_ms(lambda: run(x.to(dev)), reps=5) / SPOT_FRAMES
    t0 = time.perf_counter()
    cpu = run(x)
    t_cpu = (time.perf_counter() - t0) * 1e3 / SPOT_FRAMES
    c, r, v, lab = card
    if not (torch.equal(v, cpu[2]) and torch.equal(c[v], cpu[0][cpu[2]])
            and torch.equal(r[v], cpu[1][cpu[2]]) and torch.equal(lab, cpu[3])):
        raise AssertionError("(d) spots: card != CPU (coordinates, radii or labels)")
    n = v.sum(dim=1).tolist()
    log(f"[zoo] (d) spots on {SPOT_FRAMES} frames of {ZOO_SIZE}^2: {ms:.2f} ms a frame on the "
        f"card (H2D included; CUDA events, median of 5), CPU {t_cpu:.1f} ms a frame; spots a "
        f"frame {n}; coordinates, radii and labels == the CPU's")
    return {"ms_per_frame": ms, "cpu_ms_per_frame": t_cpu, "spots": n}


def zoo_phase(dev) -> dict:
    """Phase 7: the model zoo and the model server. Returns its numbers and
    the kernel rows of kernels 1-5 at the CPnet mesh call's shapes."""
    import tempfile

    from aliby_tpu_torch.io import zarrlite
    from aliby_tpu_torch.io.dataset import DatasetZarr
    from aliby_tpu_torch.test_data import cellpainting_movie

    wrappers = main_wrappers()
    t0 = time.perf_counter()
    movie = cellpainting_movie(1, ZOO_TPS, ZOO_SIZE, seed=19)
    tmp = tempfile.TemporaryDirectory(prefix="aliby_zoo_")
    store = os.path.join(tmp.name, "plate.zarr")
    zarrlite.write_array(os.path.join(store, "pos0"), movie[0],
                         chunks=(1, 1, 1, ZOO_SIZE, ZOO_SIZE), compressor="zlib")
    positions = DatasetZarr(store).get_position_ids()
    log(f"[zoo] 1 position x {ZOO_TPS} tps x 5 channels x {ZOO_SIZE}^2 uint16 written in "
        f"{time.perf_counter() - t0:.1f} s")
    out = {}
    t = time.perf_counter()
    out["cpnet"], rows = zoo_cpnet(dev, tmp.name, positions, movie, wrappers)
    log(f"[zoo] (a) {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    out["example02"] = zoo_embeddings(dev, tmp.name)
    log(f"[zoo] (b) {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    out["server"] = zoo_server(dev, tmp.name, positions, wrappers)
    log(f"[zoo] (c) {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    out["spots"] = zoo_spots(dev, movie)
    log(f"[zoo] (d) {time.perf_counter() - t:.1f} s")
    tmp.cleanup()
    return out, rows


# ------------------------------------------------------------------ phase 8
TRAINING = " (training targets)"
TRAIN_BATCH, TRAIN_SIZE = 8, 128  # scripts/torch_train_flagship.py's batches
TRAIN_FRESH, TRAIN_RESUMED, TRAIN_SAME = 30, 20, 5  # steps of (a), (b) and each run of (e)
TRAIN_PEAK_FRESH, TRAIN_PEAK_RESUMED, TRAIN_ALPHA = 2e-3, 5e-4, 0.05
QUALITY_COUNT, QUALITY_IOU = 3, 0.85  # tests/test_models.py::test_trained_cellpose_quality


# (d): scripts/torch_train_parity.py's resumed run, held to the JAX loop's
# held-out IoU on the CPU through the f32 engines (there the port's engine is
# JAX's, label for label). In bf16 the labels of the poorly segmented nuclei
# set differ by whole objects: the port's bf16 U-Net has the error of JAX's
# compiled with every bf16 rounding the Flax model writes, XLA:CPU's default
# compile skips some, and JAX's own held-out IoU moves as far between those
# two compiles (the script's --witness): the bf16 IoU is printed, not held;
# the bf16 U-Net's error against its f64 forward is held (below). The JAX
# engine on the JAX
# checkpoint in f32 and in bf16, and the chaos floor of the f32 engines
# (JAX's own spread when its initial parameters move by one ulp), as
#   python scripts/torch_train_parity.py            (seed 0, 400 steps, resumed)
#   python scripts/torch_train_parity.py --perturb
# printed them on the CPU (both runs' checkpoints then evaluated again with
# --evaluate), the port's package as at commit d0907b3.
PARITY_SEED, PARITY_STEPS, PARITY_HELDOUT, PARITY_MARGIN = 0, 400, 6, 0.005
PARITY_JAX_IOU = {"plain": 0.9664, "budding": 0.9485, "nuclei": 0.4005}
PARITY_FLOOR = {"plain": 0.0, "budding": 0.0, "nuclei": 0.0001}
PARITY_JAX_IOU_BF16 = {"plain": 0.9665, "budding": 0.9463, "nuclei": 0.3848}
# the bf16 U-Net's flow error against an f64 forward (RMS, relative) on the
# CPU port's checkpoint of that run, as `python scripts/torch_train_parity.py
# --witness 10` printed it on the CPU (the port's U-Net as at d0907b3): the
# port, JAX compiled with every bf16 rounding,
# JAX as XLA:CPU compiles it by default. Held: the card's within
# PARITY_BF16_ERROR_RATIO of JAX's with every rounding, a set (the bf16
# forward rounds no more than the Flax model's program; read 0.990-1.001)
PARITY_BF16_ERROR_RATIO = 1.05
PARITY_BF16_ERROR = {"port": {"plain": 0.03327, "budding": 0.04704, "nuclei": 0.05013},
                     "jax, every rounding": {"plain": 0.0332, "budding": 0.04759,
                                             "nuclei": 0.05049},
                     "jax": {"plain": 0.02936, "budding": 0.04159, "nuclei": 0.04556}}


def script_length_run(dev, wrappers: dict, tmp: str) -> dict:
    """(d) The resumed f32 run of the training script's length on the card,
    then its held-out IoU against the JAX loop's on the CPU."""
    from aliby_tpu_torch.models import training as T
    from aliby_tpu_torch.models.segment import CellposeTorch

    def counted(fn):
        for w in wrappers.values():
            w.launches = 0
        out = fn()
        sync()
        return out, {k: w.launches for k, w in wrappers.items()}

    model = train_model(dev, torch.float32, bundled=True)
    (losses, wall), train_launches = counted(lambda: train_run(
        model, PARITY_STEPS, TRAIN_PEAK_RESUMED, PARITY_SEED, dev))
    path = os.path.join(tmp, "parity.msgpack")
    T.save_params(model, path)
    sets = T.heldout_sets(PARITY_HELDOUT, PARITY_HELDOUT)
    f32_engine = CellposeTorch(pretrained_path=path, flow_threshold=0.4, device=dev,
                               model_kwargs={"dtype": torch.float32})
    t0 = time.perf_counter()
    with T.tf32_off():
        iou, eval_launches = counted(lambda: T.heldout_scores(f32_engine.segment_tiles, sets))
    eval_s = time.perf_counter() - t0
    bf16_engine = CellposeTorch(pretrained_path=path, flow_threshold=0.4, device=dev)
    iou_bf16 = T.heldout_scores(bf16_engine.segment_tiles, sets)
    bf16_error = bf16_flow_error(bf16_engine, f32_engine.model, sets, dev)
    limits = {k: max(PARITY_MARGIN, PARITY_FLOOR[k]) for k in PARITY_JAX_IOU}
    gaps = {k: round(abs(iou[k] - PARITY_JAX_IOU[k]), 4) for k in PARITY_JAX_IOU}
    gaps_bf16 = {k: round(abs(iou_bf16[k] - PARITY_JAX_IOU_BF16[k]), 4)
                 for k in PARITY_JAX_IOU_BF16}
    log(f"[train] (d) the training script's length: {PARITY_STEPS} resumed f32 steps (TF32 "
        f"off, cuDNN deterministic), batch seed {PARITY_SEED}, peak lr {TRAIN_PEAK_RESUMED}, "
        f"in {wall:.2f} s ({PARITY_STEPS / wall:.3f} steps/s end to end); loss {losses[0]:.4f} "
        f"-> {losses[-1]:.4f}, mean of the last 25 {statistics.mean(losses[-25:]):.4f}; "
        f"launches while training {train_launches}; on {card()}")
    log(f"[train] (d) held-out IoU ({PARITY_HELDOUT} images a set) through CellposeTorch on the "
        f"card, f32 (TF32 off), in {eval_s:.2f} s: {iou}; the JAX loop on the CPU "
        f"{PARITY_JAX_IOU}; gaps {gaps}, limits max({PARITY_MARGIN}, chaos floor "
        f"{PARITY_FLOOR}) = {limits}; launches while evaluating {eval_launches}")
    log(f"[train] (d) the same through the bf16 engine (reported, not held): {iou_bf16}; the "
        f"JAX loop's through JAX's bf16 engine {PARITY_JAX_IOU_BF16}; gaps {gaps_bf16}")
    every = PARITY_BF16_ERROR["jax, every rounding"]
    log(f"[train] (d) the bf16 U-Net's flow error against its f64 forward on the card (RMS, "
        f"relative): {bf16_error}, ratio to JAX's with every rounding "
        f"{ {k: round(bf16_error[k] / every[k], 4) for k in every} } (held within "
        f"{PARITY_BF16_ERROR_RATIO}); on the CPU port's checkpoint {PARITY_BF16_ERROR}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"(d) non-finite losses in the {PARITY_STEPS}-step run")
    if train_launches["diffuse_heat"] <= 0:
        raise AssertionError("(d) diffuse_heat was not launched by the training targets")
    missing = [k for k in ("successor_prop", "diffuse_heat", "binned_sum_cols_batched")
               if eval_launches[k] <= 0]
    if missing:
        raise AssertionError(f"(d) {missing} not launched by the held-out evaluation")
    missed = [k for k in gaps if gaps[k] > limits[k]]
    if missed:
        raise AssertionError(f"(d) held-out IoU beyond the rule on {missed}: card {iou}, JAX "
                             f"{PARITY_JAX_IOU}, limits {limits}")
    rougher = [k for k in every if bf16_error[k] > PARITY_BF16_ERROR_RATIO * every[k]]
    if rougher:
        raise AssertionError(f"(d) the bf16 U-Net's error beyond {PARITY_BF16_ERROR_RATIO}x "
                             f"JAX's with every rounding on {rougher}: {bf16_error}, {every}")
    return {"steps": PARITY_STEPS, "s": wall, "steps_per_s": PARITY_STEPS / wall,
            "loss_first": losses[0], "loss_last25": statistics.mean(losses[-25:]),
            "heldout_iou": iou, "jax_cpu_iou": PARITY_JAX_IOU, "gaps": gaps,
            "limits": limits, "heldout_iou_bf16": iou_bf16, "gaps_bf16": gaps_bf16,
            "bf16_flow_error": bf16_error, "eval_s": eval_s,
            "train_launches": train_launches, "eval_launches": eval_launches}


def bf16_flow_error(bf16_engine, f32_model, sets: dict, dev) -> dict:
    """Per held-out set, the RMS distance of the bf16 engine's U-Net flows
    from ``forward_f64`` of the same parameters, relative to the f64 flows'
    RMS, on the engine's normalised inputs."""
    from aliby_tpu_torch.models.segment import _normalize_percentile
    from aliby_tpu_torch.models.unet import forward_f64

    out = {}
    for name, items in sets.items():
        images = torch.from_numpy(np.stack([img for img, _ in items])).to(dev)
        with torch.no_grad():
            x = _normalize_percentile(images.permute(0, 2, 3, 1))
            want = forward_f64(f32_model, x)[..., :2]
            got = bf16_engine._forward(x)[..., :2].double()
        out[name] = round(float(torch.sqrt(((got - want) ** 2).mean() / (want ** 2).mean())), 5)
    return out


def train_model(dev, dtype=torch.bfloat16, bundled=False):
    """The flagship at full width from ``init_params(seed=0)``, or with the
    bundled weights loaded by the port's ``load_params``."""
    from aliby_tpu_torch.models.training import load_params
    from aliby_tpu_torch.models.unet import init_params
    from aliby_tpu_torch.models.weights import BUNDLED_WEIGHTS

    model = init_params(0, in_channels=2, size=TRAIN_SIZE, device=dev, dtype=dtype)
    if bundled:
        model.load_state_dict(load_params(BUNDLED_WEIGHTS, model))
    return model


def train_run(model, steps: int, peak: float, seed: int, dev) -> tuple[list, float]:
    """``scripts/torch_train_flagship.py``'s loop: AdamW on a cosine schedule
    (alpha 0.05), a fresh synthetic batch of 8 at 128^2 a step (host render,
    then the targets on the card). Returns the losses and the wall seconds;
    the losses are read once, at the end."""
    from aliby_tpu_torch.models.training import (
        adamw,
        cosine_decay_schedule,
        make_train_step,
        synthetic_batch,
    )

    opt, scheduler = adamw(model.parameters(), cosine_decay_schedule(peak, steps, TRAIN_ALPHA))
    step = make_train_step(model, opt, scheduler)
    rng = np.random.default_rng(seed)
    sync()
    t0 = time.perf_counter()
    losses = [step(synthetic_batch(rng, TRAIN_BATCH, TRAIN_SIZE, device=dev))["loss"]
              for _ in range(steps)]
    losses = torch.stack(losses).tolist()
    return losses, time.perf_counter() - t0


def same_parameters(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))


def quality_gate(seg) -> tuple[int, float]:
    """``test_trained_cellpose_quality``'s field (render_cells(128, 10), rng
    77, noise 0.03): the object count's distance from the truth's and the
    mean matched IoU of the truth's objects."""
    from aliby_tpu_torch.test_data import render_cells

    rng = np.random.default_rng(77)
    cells, nuclei, labels = render_cells(128, 10, rng)
    noise = rng.normal(0, 0.03, cells.shape).astype(np.float32)
    mask = seg(np.stack([cells + noise, nuclei + noise])[None][:, :, None])[0]
    return abs(int(mask.max()) - int(labels.max())), matched_iou(labels, mask)


def f32_step_against_cpu(dev) -> dict:
    """(e) One f32 step at full width on the card (TF32 off inside the step)
    and on the CPU, on one batch: the loss within LOSS_RTOL and each gradient
    within the card's limits of ``extract.tolerances.gradient_excess``."""
    from aliby_tpu_torch.extract.tolerances import (
        GRAD_CARD_FLOOR_ATOL,
        GRAD_CARD_RTOL,
        LOSS_RTOL,
        gradient_excess,
    )
    from aliby_tpu_torch.models.training import adamw, make_train_step, synthetic_batch

    batch = synthetic_batch(np.random.default_rng(3), TRAIN_BATCH, TRAIN_SIZE, device="cpu")
    out = {}
    for where in ("cpu", dev):
        model = train_model(where, torch.float32)
        opt, scheduler = adamw(model.parameters(), TRAIN_PEAK_FRESH)
        grads = {}
        opt.register_step_pre_hook(lambda *a, model=model, grads=grads: grads.update(
            {n: p.grad.detach().cpu().numpy() for n, p in model.named_parameters()}))
        t0 = time.perf_counter()
        metrics = make_train_step(model, opt, scheduler)({k: v.to(where)
                                                          for k, v in batch.items()})
        out[str(where)] = (float(metrics["loss"]), grads, time.perf_counter() - t0)
    (loss_c, grads_c, s_c), (loss_g, grads_g, _) = out["cpu"], out[str(dev)]
    rel = abs(loss_g - loss_c) / abs(loss_c)
    excess = gradient_excess(grads_g, grads_c, GRAD_CARD_RTOL, GRAD_CARD_FLOOR_ATOL)
    name, (worst, _) = max(excess.items(), key=lambda kv: kv[1][0])
    log(f"[train] (e) one f32 step, card (TF32 off) vs CPU ({s_c:.1f} s on the CPU): loss "
        f"{loss_g:.6f} vs {loss_c:.6f} (rel {rel:.3g}, limit {LOSS_RTOL}); worst gradient "
        f"{name} at {worst:.3g} of its limit ({GRAD_CARD_RTOL} of the tensor's largest |g|); "
        f"{sum(f for _, f in excess.values())} rounding-only tensors")
    if rel > LOSS_RTOL or worst > 1:
        raise AssertionError(f"(e) the f32 card step differs from the CPU's: loss rel {rel}, "
                             f"{name} at {worst} of its limit")
    return {"loss_rel": rel, "worst_gradient": name, "worst_share_of_limit": worst}


def training_phase(dev) -> tuple[dict, dict]:
    """Phase 8: training. Returns its numbers and the kernel row of the
    targets' ``diffuse_heat`` call."""
    import tempfile

    from aliby_tpu_torch.models import flows
    from aliby_tpu_torch.models import training as T
    from aliby_tpu_torch.models.segment import CellposeTorch, dispatch_segmenter
    from aliby_tpu_torch.ops import segsum, stencil
    from aliby_tpu_torch.utils import profiling

    out = {}
    tmp = tempfile.TemporaryDirectory(prefix="aliby_train_")

    # (a) a fresh run at train_flagship's configuration, counted
    model = train_model(dev)
    wrappers = {"successor_prop": stencil.successor_prop, "diffuse_heat": stencil.diffuse_heat,
                "binned_sum_cols_batched": segsum.binned_sum_cols_batched,
                "binned_minmax_batched": segsum.binned_minmax_batched,
                "table_lookup_batched": segsum.table_lookup_batched,
                "segment_sum_matmul": segsum.segment_sum_matmul}
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with Recorder(flows, "diffuse_heat") as rec:
        losses, wall = train_run(model, TRAIN_FRESH, TRAIN_PEAK_FRESH, 0, dev)
    all_launches = {k: w.launches for k, w in wrappers.items()}
    launches = all_launches["diffuse_heat"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    per_step = launches / TRAIN_FRESH
    first, last = statistics.mean(losses[:5]), statistics.mean(losses[-5:])
    log(f"[train] (a) fresh, bf16, widths {model.feats}, batch {TRAIN_BATCH} at {TRAIN_SIZE}^2, "
        f"peak lr {TRAIN_PEAK_FRESH}: {TRAIN_FRESH} steps in {wall:.2f} s "
        f"({TRAIN_FRESH / wall:.3f} steps/s end to end), peak {peak:.3f} GB; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, mean of the first 5 {first:.4f}, of the last 5 "
        f"{last:.4f}; kernel launches {all_launches} ({per_step:g} diffuse_heat a step)")
    if launches <= 0 or rec.args is None:
        raise AssertionError("(a) diffuse_heat was not launched by the training targets")
    if per_step != stencil.diffuse_launches(STENCIL_ROUNDS):
        raise AssertionError(f"(a) {per_step} diffuse_heat launches a train step, expected "
                             f"{stencil.diffuse_launches(STENCIL_ROUNDS)}")
    if tuple(rec.args[0].shape) != (TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE):
        raise AssertionError(f"(a) the targets' call had shape {tuple(rec.args[0].shape)}")
    if not all(np.isfinite(losses)) or not last < first:
        raise AssertionError(f"(a) the loss did not fall: {first} -> {last}")
    out["fresh"] = {"steps": TRAIN_FRESH, "s": wall, "steps_per_s": TRAIN_FRESH / wall,
                    "peak_gb": peak, "loss_first5": first, "loss_last5": last,
                    "diffuse_heat_launches": launches}

    # (b) resumed from the bundled weights, saved, segmented from the file
    model = train_model(dev, bundled=True)
    losses_b, wall_b = train_run(model, TRAIN_RESUMED, TRAIN_PEAK_RESUMED, 1, dev)
    path = os.path.join(tmp.name, "resumed.msgpack")
    T.save_params(model, path)
    in_memory = CellposeTorch(device=dev)
    in_memory.model.load_state_dict({k: v.to(torch.float16).to(torch.float32)
                                     for k, v in model.state_dict().items()})
    from_file = dispatch_segmenter("cellpose", 0, second_channel=1, pretrained_path=path,
                                   device=dev)
    bundled = dispatch_segmenter("cellpose", 0, second_channel=1, device=dev)
    counts = []
    for seed in (77, 78):
        rng = np.random.default_rng(seed)
        fields = np.stack([np.stack(T._render(rng, TRAIN_SIZE, 0.3, 0.3)[:2]) for _ in range(4)])
        got = from_file(fields[:, :, None])
        want = in_memory.segment_tiles(fields)
        counts.append([int(m.max()) for m in want])
        if not all(np.array_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"(b) the port-written checkpoint does not segment as the "
                                 f"parameters in memory (objects {counts[-1]}, from the file "
                                 f"{[int(m.max()) for m in got]})")
        x = torch.from_numpy(fields.transpose(0, 2, 3, 1).copy()).to(dev)
        with torch.no_grad():
            if not torch.equal(from_file.engine.model(x), in_memory.model(x)):
                raise AssertionError("(b) the U-Net from the port-written file differs from "
                                     "the parameters in memory")
    gates = {"bundled": quality_gate(bundled), "resumed": quality_gate(from_file)}
    log(f"[train] (b) resumed from the bundled weights, peak lr {TRAIN_PEAK_RESUMED}: "
        f"{TRAIN_RESUMED} steps in {wall_b:.2f} s, loss {statistics.mean(losses_b[:5]):.4f} "
        f"(first 5) -> {statistics.mean(losses_b[-5:]):.4f} (last 5); saved with save_params "
        f"({os.path.getsize(path)} bytes); from the file on the card, the U-Net's output bits "
        f"and the labels of the f16-rounded parameters in memory (8 fields, objects {counts}); "
        f"quality gate (|count - truth|, matched IoU): " +
        ", ".join(f"{k} {c}, {iou:.4f}" for k, (c, iou) in gates.items()))
    c, iou = gates["bundled"]
    if c > QUALITY_COUNT or not iou > QUALITY_IOU:
        raise AssertionError(f"(b) the bundled weights fail the quality gate: {c}, {iou}")
    out["resumed"] = {"steps": TRAIN_RESUMED, "s": wall_b,
                      "loss_first5": statistics.mean(losses_b[:5]),
                      "loss_last5": statistics.mean(losses_b[-5:]),
                      "quality": {k: {"count_off": c, "matched_iou": i}
                                  for k, (c, i) in gates.items()}}

    # (c) the targets' diffuse_heat call: bit-equal to plain, timed beside its bound
    log("[report] diffuse_heat at the training targets' call (launches: the fresh run of "
        f"{TRAIN_FRESH} steps):")
    row = measure_kernels({"diffuse_heat": rec.args}, {"diffuse_heat": launches})["diffuse_heat"]
    row["name"] = "diffuse_heat" + TRAINING
    row["launches_per_train_step"] = per_step
    rows = {row["name"]: row}

    # (d) the training script's length against the JAX loop's held-out IoU
    out["script_length"] = script_length_run(dev, wrappers, tmp.name)

    # (e) identity across runs, f32 against the CPU, no host sync in the step
    for dtype in (torch.float32, torch.bfloat16):
        a, b = train_model(dev, dtype), train_model(dev, dtype)
        la, _ = train_run(a, TRAIN_SAME, TRAIN_PEAK_FRESH, 2, dev)
        lb, _ = train_run(b, TRAIN_SAME, TRAIN_PEAK_FRESH, 2, dev)
        if la != lb or not same_parameters(a, b):
            raise AssertionError(f"(e) two {dtype} runs of {TRAIN_SAME} steps differ")
    log(f"[train] (e) two runs of {TRAIN_SAME} steps from one seed, f32 and bf16: the same "
        f"losses and parameter bits")
    out["f32_vs_cpu"] = f32_step_against_cpu(dev)
    model = train_model(dev)
    opt, scheduler = T.adamw(model.parameters(), TRAIN_PEAK_RESUMED)
    step = T.make_train_step(model, opt, scheduler)
    rng = np.random.default_rng(4)
    batch = T.synthetic_batch(rng, TRAIN_BATCH, TRAIN_SIZE, device=dev)
    step(batch)
    sync()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log("[train] (e) a train step under torch.cuda.set_sync_debug_mode('error'): no host sync")

    # (f) where a step's time goes
    labels = torch.from_numpy(np.stack([T._render(rng, TRAIN_SIZE, 0.0, 0.0)[2]
                                        for _ in range(TRAIN_BATCH)]).astype(np.int32)).to(dev)
    times = {"host_render_ms": host_ms(lambda: [T._render(rng, TRAIN_SIZE, 0.0, 0.0)
                                                for _ in range(TRAIN_BATCH)]),
             "targets_ms": cuda_ms(lambda: flows.masks_to_flows(labels))}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        model = train_model(dev, dtype)
        opt, scheduler = T.adamw(model.parameters(), TRAIN_PEAK_RESUMED)
        step = T.make_train_step(model, opt, scheduler)

        def forward_backward():
            model.zero_grad(set_to_none=True)
            with T.deterministic_cudnn(), (T.tf32_off() if dtype == torch.float32
                                           else contextlib.nullcontext()):
                T.loss_fn(model, batch)[0].backward()

        times[f"step_ms_{name}"] = cuda_ms(lambda: step(batch))
        times[f"forward_backward_ms_{name}"] = cuda_ms(forward_backward)
        times[f"optimizer_ms_{name}"] = cuda_ms(opt.step)
        if dtype == torch.bfloat16:
            main_step = step
    log("[train] (f) " + ", ".join(f"{k} {v:.3f}" for k, v in times.items()) +
        " (CUDA events, median of 21; the host render by the host clock)")
    out["times"] = times

    def steps(n=3):
        for _ in range(n):
            main_step(T.synthetic_batch(rng, TRAIN_BATCH, TRAIN_SIZE, device=dev))

    share = device_share(steps, what="3 train steps, batches included (bf16)")
    out["idle_share"] = None if share is None else share["idle_share"]
    names = ("train_targets", "train_step")
    with profiling.trace(os.path.join(tmp.name, "trace")) as prof:
        for _ in range(2):
            with profiling.span(names[0]):
                b = T.synthetic_batch(rng, TRAIN_BATCH, TRAIN_SIZE, device=dev)
            with profiling.span(names[1]):
                main_step(b)
        sync()
    found = {e.key for e in prof.key_averages()}
    trace_bytes = os.path.getsize(os.path.join(tmp.name, "trace", "trace.json"))
    if not set(names) <= found:
        raise AssertionError(f"(f) the span names {names} are not in the profile")
    log(f"[train] (f) profiling.trace of 2 steps: {trace_bytes} bytes of Chrome trace, the "
        f"span names {names} found")
    tmp.cleanup()
    return out, rows


# ------------------------------------------------------------------ phase 9
PLATE_SIZE = 1080  # JUMP's field size
PLATE_WELLS, PLATE_FIELDS, PLATE_SEED = ("A01", "B02"), (1, 2), 21
PLATE_STRIP_ROWS = (64, 100, 135, 256)  # rows a strip, by file: several strips a file
TIFF_PLATE = " (TIFF plate)"


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def write_tiff(path, arr: np.ndarray, rows_per_strip: int, deflate: bool = False,
               big_endian: bool = False) -> None:
    """A baseline single-page TIFF of a 2-D uint8/uint16 array (numpy,
    ``struct`` and ``zlib`` only): strips of ``rows_per_strip`` rows,
    uncompressed or deflate (compression 8, a zlib stream a strip), little-
    or big-endian (``II`` / ``MM``), black is zero."""
    import struct
    import zlib

    e = ">" if big_endian else "<"
    H, W = arr.shape
    data = np.ascontiguousarray(arr, dtype=arr.dtype.newbyteorder(e))
    strips = [data[y:y + rows_per_strip].tobytes() for y in range(0, H, rows_per_strip)]
    if deflate:
        strips = [zlib.compress(s) for s in strips]
    offsets = list(np.cumsum([8] + [len(s) for s in strips[:-1]]))
    ifd_at = 8 + sum(len(s) for s in strips)
    ifd_at += ifd_at % 2  # the IFD starts on a word
    entries = [(256, 4, [W]), (257, 4, [H]), (258, 3, [8 * arr.itemsize]),
               (259, 3, [8 if deflate else 1]), (262, 3, [1]), (273, 4, offsets),
               (277, 3, [1]), (278, 4, [rows_per_strip]), (279, 4, [len(s) for s in strips])]
    extra_at = ifd_at + 2 + 12 * len(entries) + 4
    ifd, extra = struct.pack(e + "H", len(entries)), b""
    for tag, typ, vals in entries:
        fmt = "H" if typ == 3 else "I"
        packed = struct.pack(e + fmt * len(vals), *(int(v) for v in vals))
        if len(packed) <= 4:
            field = packed.ljust(4, b"\0")
        else:
            field = struct.pack(e + "I", extra_at + len(extra))
            extra += packed
        ifd += struct.pack(e + "HHI", tag, typ, len(vals)) + field
    ifd += struct.pack(e + "I", 0)
    body = b"".join(strips)
    with open(path, "wb") as f:
        f.write((b"MM" if big_endian else b"II") + struct.pack(e + "HI", 42, ifd_at) + body
                + b"\0" * (ifd_at - 8 - len(body)) + ifd + extra)


def tiff_plate(root: str, size: int, deflate: bool) -> dict:
    """Example 01's plate: 2 wells x 2 fields x 5 channels of ``size``^2
    uint16 (``cellpainting_large_field`` at ``rint(4096 x)``), a file a
    plane named by example 01's convention; every other file deflate (where
    ``deflate``), every third big-endian, strips of 64 to 256 rows. Returns
    {path: (array, deflate, big-endian)}."""
    from aliby_tpu_torch.test_data import CP_CHANNELS, cellpainting_large_field

    written, i = {}, 0
    for wi, well in enumerate(PLATE_WELLS):
        for fi, field in enumerate(PLATE_FIELDS):
            stack = cellpainting_large_field(size, seed=PLATE_SEED + 2 * wi + fi)[0, :, 0]
            stack = np.clip(np.rint(stack * 4096), 0, 65535).astype(np.uint16)
            for ch_name, ch in CP_CHANNELS.items():
                path = os.path.join(root, f"plate1__{well}__{field}__{ch_name}.tif")
                layout = (deflate and i % 2 == 1, i % 3 == 0)
                write_tiff(path, stack[ch], PLATE_STRIP_ROWS[i % len(PLATE_STRIP_ROWS)], *layout)
                written[path] = (stack[ch], *layout)
                i += 1
    return written


def decode_checks(written: dict) -> dict:
    """Every plane through ``tiff_decode`` and ``tiff_decode_batch``, bit-equal
    to the array written; ms a plane of each (host clock, median of 3)."""
    from aliby_tpu_torch import native

    for path, (arr, deflate, big) in written.items():
        got = native.tiff_decode(path)
        if got is None or got.dtype != arr.dtype or not np.array_equal(got, arr):
            raise AssertionError(f"tiff_decode({os.path.basename(path)}) != the array written "
                                 f"(deflate {deflate}, big-endian {big})")
    paths = list(written)
    batch = native.tiff_decode_batch(paths)
    if batch is None or not all(np.array_equal(b, written[p][0]) for b, p in zip(batch, paths)):
        raise AssertionError("tiff_decode_batch != the arrays written")
    ms = {}
    for kind in (False, True):
        group = [p for p, (_, d, _) in written.items() if d == kind]
        if not group:
            continue
        name = "deflate" if kind else "uncompressed"
        for what, fn in (("single", lambda: [native.tiff_decode(p) for p in group]),
                         ("batch", lambda: native.tiff_decode_batch(group))):
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3 / len(group))
            ms[f"{what}_{name}"] = statistics.median(times)
    return ms


def tiff_plate_phase(dev, size=PLATE_SIZE) -> tuple[dict, dict]:
    """Phase 9: example 01 from a TIFF plate, decoded by the port's native
    decoder; returns (stats, kernel rows)."""
    import tempfile

    from aliby_tpu_torch import native
    from aliby_tpu_torch.engine.builders import build_pipeline_steps
    from aliby_tpu_torch.engine.core import profile_columns, run_pipeline_return_state
    from aliby_tpu_torch.io import image, jxl, zarrlite
    from aliby_tpu_torch.io.dataset import DatasetDir, DatasetZarr
    from aliby_tpu_torch.parallel.pipeline_mesh import run_positions_mesh_states
    from aliby_tpu_torch.parallel.positions import stamp_image_kwargs
    from aliby_tpu_torch.pipe import init_step
    from aliby_tpu_torch.test_data import DATASETS

    stats = {}
    # (a) the decoder, built from the checkout's source
    t0 = time.perf_counter()
    lib = native.build()
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True,
                         check=True).stdout.splitlines()[0]
    zlib_ok = native.has_zlib()
    log(f"[plate] (a) {gxx}; <zlib.h> {'found' if zlib_ok else 'NOT found: deflate compiled out'}"
        f"; {os.path.relpath(lib, ROOT)} in {time.perf_counter() - t0:.1f} s")
    if not native.available():
        raise AssertionError("the native decoder was built but does not load")

    # (b) the plate
    tmp = tempfile.TemporaryDirectory(prefix="aliby_plate_")
    plate = os.path.join(tmp.name, "plate")
    os.makedirs(plate)
    t0 = time.perf_counter()
    written = tiff_plate(plate, size, deflate=zlib_ok)
    mb = sum(a.nbytes for a, _, _ in written.values()) / 1e6
    log(f"[plate] (b) {len(written)} TIFFs of {size}^2 uint16 ({mb:.1f} MB of pixels; "
        f"{sum(d for _, d, _ in written.values())} deflate, "
        f"{sum(b for _, _, b in written.values())} big-endian) in {time.perf_counter() - t0:.1f} s")

    # (c) the decode, bit-equal and timed
    stats["decode_ms_a_plane"] = decode_checks(written)
    log("[plate] (c) tiff_decode and tiff_decode_batch bit-equal to the arrays written; ms a "
        "plane (host clock): " + ", ".join(f"{k} {v:.3f}" for k, v in
                                           stats["decode_ms_a_plane"].items()))

    # (d) example 01 through the mesh and per position, every read counted
    regex = DATASETS["crop_cellpainting_256"]["regex"]
    positions = DatasetDir(plate, regex=regex, capture_order="WFC").get_position_ids()
    if len(positions) != 4:
        raise AssertionError(f"DatasetDir found {len(positions)} positions, want 4")
    base = build_pipeline_steps(**EXAMPLE01)
    base["compiled"] = True
    wrappers = main_wrappers()
    reads, lock, read = [0], threading.Lock(), image._read_image_file

    def counted_read(path):
        with lock:
            reads[0] += 1
        return read(path)

    def mesh(tag):
        entries, _ = run_positions_mesh_states(base, positions, os.path.join(tmp.name, tag),
                                               regex=regex, capture_order="WFC", device=dev)
        return [(e["pipeline"], e["state"]) for e in entries]

    def per_position(tag):
        return [(p, run_pipeline_return_state(p, os.path.join(tmp.name, tag, p["io"]["input_path"]
                                                              ["key"]), init_step, device=dev))
                for p in (stamp_image_kwargs(base, pos, regex=regex, capture_order="WFC")
                          for pos in positions)]

    recs = mesh_call_recorders()
    run_pipeline_return_state(stamp_image_kwargs(base, positions[0], regex=regex,
                                                 capture_order="WFC"),
                              os.path.join(tmp.name, "warm-up"), init_step, device=dev)
    decodes0 = native.decodes
    image._read_image_file = counted_read
    try:
        for w in wrappers.values():
            w.launches = 0
        sync()
        torch.cuda.reset_peak_memory_stats()
        with recording(recs.values()):
            t0 = time.perf_counter()
            mesh_runs = mesh("mesh")
            sync()
            t_mesh = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
        stats["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        t0 = time.perf_counter()
        per_runs = per_position("per")
        sync()
        t_per = time.perf_counter() - t0
    finally:
        image._read_image_file = read
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"example 01 on the TIFF plate did not launch {missing} ({launches})")
    n_decodes = native.decodes - decodes0
    if n_decodes != reads[0] or reads[0] < 2 * len(written):
        raise AssertionError(f"{reads[0]} reads of the data plane, {n_decodes} native decodes "
                             f"({len(written)} files, two runs)")
    stats.update(fields_per_s={"mesh": len(positions) / t_mesh,
                               "per_position": len(positions) / t_per},
                 launches=launches, reads=reads[0], native_decodes=n_decodes)
    log(f"[plate] (d) {len(positions)} positions {[p['key'] for p in positions]}: mesh "
        f"{t_mesh:.2f} s ({len(positions) / t_mesh:.3f} fields/s), per position {t_per:.2f} s "
        f"({len(positions) / t_per:.3f} fields/s), peak device memory {stats['peak_gb']:.3f} GB "
        f"(the mesh run); {reads[0]} reads by the data plane = {n_decodes} native decodes; "
        f"launches in the mesh run {launches}")
    with open(os.path.join(ROOT, "tests", "golden", FUSED_PATHS["example-01"][2])) as f:
        golden = {c for c in f.read().splitlines() if c and not c.startswith("metadata_")}
    profiles = []
    for (pm, sm), (pp, sp) in zip(mesh_runs, per_runs):
        key = pp["io"]["input_path"]["key"]
        cols = profile_columns(sp, pp)
        if not same_columns(profile_columns(sm, pm), cols):
            raise AssertionError(f"{key}: the mesh's profile columns != the per-position run's")
        names = {c for c in cols if not c.startswith("metadata_")}
        if names != golden or not len(cols["metadata_tile"]):
            raise AssertionError(f"{key}: {len(names)} profile columns, {len(golden)} golden "
                                 f"example-01 columns; {len(cols['metadata_tile'])} rows")
        profiles.append(cols)
    log(f"[plate] (d) mesh == per position: {len(golden)} profile columns (the golden example-01 "
        f"set) x {[len(c['metadata_tile']) for c in profiles]} rows (NaN equal)")

    # (e) one position's pixels, read back through the data plane, in a zlib zarr
    # store, and (f) in a JPEG-XL one where the host has libjxl: the same profile
    img = image.dispatch_image(positions[0])(positions[0], regex=regex, capture_order="WFC")
    pixels = np.asarray(img.get_data_lazy()[0, :, 0])  # (C, Y, X)
    want = np.stack([written[p][0] for p in positions[0]["path"]])
    if not np.array_equal(pixels, want):
        raise AssertionError("the image layer's pixels of position 0 != the arrays written")
    codecs = ["zlib"] + ["jpegxl"] * jxl.available()
    for codec in codecs:
        store = os.path.join(tmp.name, f"store_{codec}")
        zarrlite.write_array(os.path.join(store, positions[0]["key"]), pixels,
                             chunks=(1, size, size), compressor=codec)
        zpos = DatasetZarr(store).get_position_ids()[0]
        if not np.array_equal(zarrlite.ZarrArray(zpos["path"])[:], pixels):
            raise AssertionError(f"the {codec} zarr store's pixels != the TIFFs'")
        pipe = stamp_image_kwargs(base, zpos, capture_order="CYX")
        st = run_pipeline_return_state(pipe, os.path.join(tmp.name, f"z_{codec}"), init_step,
                                       device=dev)
        if not same_columns(profile_columns(st, pipe), profiles[0]):
            raise AssertionError(f"{positions[0]['key']}: the {codec} zarr profile != the TIFF's")
        log(f"[plate] ({'e' if codec == 'zlib' else 'f'}) {positions[0]['key']} from a {codec} "
            f"zarr store: the same pixels and profile columns as from its TIFFs")
    if not jxl.available():
        log("[plate] (f) jxl: libjxl not found on this host")
    stats["jxl"] = jxl.available()
    loaded = [m for m in ("imageio", "PIL") if m in sys.modules]
    if loaded:
        raise AssertionError(f"the TIFF plate's path imported {loaded}")

    # (g) the idle share of one mesh call, the kernels at the mesh call's shapes
    stats["idle"] = device_share(lambda: mesh("idle"), f"the example-01 mesh call, "
                                 f"{len(positions)} fields of {size}^2", warmup=False,
                                 host_ops=False)
    missing = [k for k, r in recs.items() if r.args is None]
    if missing:
        raise AssertionError(f"no call of {missing} was recorded in the mesh run")
    log(f"[report] kernels 1-5 at the TIFF plate's mesh call's shapes (launches: the mesh run; "
        f"{card()}):")
    rows = {}
    for name, row in measure_kernels({k: r.args for k, r in recs.items()}, launches).items():
        row["name"] = name + TIFF_PLATE
        rows[name + TIFF_PLATE] = row
    log(f"[plate] {card()}: " + json.dumps(stats))
    tmp.cleanup()
    return stats, rows


# ------------------------------------------------------------------ phase 10
DP_SHARDS = " (dp shards)"
MULTI_PLATE = (3, 4, 512, 2)  # the tracked plate: positions, tps, size, chunk
MULTI_PLATE_CELLS = (20, 24, None)  # cells a position; None: the bench's density (96 at 512^2)
FLAGSHIP = (32, 64, 128, 256)
MULTI_TRAIN = {"feats": FLAGSHIP, "size": 128, "batch": 8, "steps": 3, "lr": 1e-3}
MULTI_FORWARD = {"feats": FLAGSHIP, "size": 1080, "batch": 2, "seed": 11, "weights": "bundled",
                 "reps": 2}


def example04_pipeline(ntps: int | None = None) -> dict:
    """``examples/04_mesh_parallel_plate.py``'s pipeline (nuclei on DNA, cell
    on AGP, intensity without edges and sizeshape); with ``ntps`` also a
    stitch tracker per object, compiled, segments and tracks saved."""
    from aliby_tpu_torch.engine.builders import build_pipeline_steps
    from aliby_tpu_torch.test_data import get_dataset

    ch = get_dataset("crop_cellpainting_256")["channels"]
    pipeline = build_pipeline_steps(
        channels_to_segment={"nuclei": ch["DNA"], "cell": ch["AGP"]},
        channels_to_extract=[ch["DNA"], ch["AGP"]], features_to_extract=("intensity", "sizeshape"),
        cp_measure_feature_kwargs={"intensity": {"edge_measurements": False}})
    if ntps is not None:
        for obj in ("nuclei", "cell"):
            pipeline["steps"][f"track_{obj}"] = {"kind": "stitch", "max_labels": 256,
                                                 "iou_threshold": 0.25}
            pipeline["passed_data"][f"track_{obj}"] = [("masks", f"segment_{obj}")]
        pipeline["save"] = [f"{k}_{o}" for k in ("segment", "track") for o in ("nuclei", "cell")]
        pipeline.update(ntps=ntps, compiled=True)
    return pipeline


def mesh_plate_runs(what: str, base: dict, positions: list, tmp: str, meshes: dict, dev,
                    recorders: dict | None = None, **kw) -> dict:
    """``run_positions_mesh_states`` of ``base`` on each of ``meshes`` (tag
    -> mesh, or None: ``device=dev``, dp = 1), every launch counter set to
    0 before each (each run starts at the fused step's initial width);
    ``recorders`` (tag -> recorders) record during that tag's run. Returns
    {tag: (entries, launches of the run, launches of each shard, seconds,
    state after)}."""
    from aliby_tpu_torch.parallel.pipeline_mesh import run_positions_mesh_states

    wrappers = main_wrappers()
    out = {}
    for tag, mesh in meshes.items():
        report = {}
        for w in wrappers.values():
            w.launches = 0
        sync()
        with recording((recorders or {}).get(tag, [])):
            t0 = time.perf_counter()
            entries, _ = run_positions_mesh_states(
                base, positions, os.path.join(tmp, tag), mesh=mesh,
                device=None if mesh is not None else dev, overwrite=True, report=report, **kw)
            sync()
            seconds = time.perf_counter() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
        shards = [{k: n.get(k, 0) for k in wrappers} for n in report["shard_launches"]]
        out[tag] = (entries, launches, shards, seconds, report["state"])
        log(f"[multi] {what}, {tag}: {len(positions)} positions in {seconds:.2f} s; "
            f"launches {launches}; per shard {shards}; state after {report['state']}")
    return out


class ShardRecorder(Recorder):
    """A Recorder that keeps the first accepted call's arguments of each
    CUDA stream it is called on (a dp shard's thread runs on its own)."""

    def __init__(self, module, name, want=None):
        super().__init__(module, name, want)
        self.by_stream = {}

    def __call__(self, *args, **kwargs):
        stream = torch.cuda.current_stream().cuda_stream
        if stream not in self.by_stream and self.want(*args):
            self.by_stream[stream] = args
        return self.fn(*args, **kwargs)


def shard_kernel_calls(args: dict) -> dict:
    """name -> (kernel call, plain call) of kernels 1-5 on one shard's
    recorded arguments, at the main path's round counts."""
    from aliby_tpu_torch.ops import segsum, stencil

    n = STENCIL_ROUNDS
    d, k = args["successor_prop"][:2]
    lab, src = args["diffuse_heat"][:2]
    vals, bins, n_bins = args["binned_sum_cols_batched"]
    mvals, mbins, m_bins = args["binned_minmax_batched"]
    table, tbins = args["table_lookup_batched"]
    return {
        "successor_prop": (lambda: stencil.successor_prop(d, k, n),
                           lambda: stencil.successor_prop_plain(d, k, n)),
        "diffuse_heat": (lambda: stencil.diffuse_heat(lab, src, n),
                         lambda: stencil.diffuse_heat_plain(lab, src, n)),
        "binned_sum_cols_batched": (lambda: segsum.binned_sum_cols_batched(vals, bins, n_bins),
                                    lambda: segsum.binned_sum_cols_batched_plain(vals, bins,
                                                                                 n_bins)),
        "binned_minmax_batched": (lambda: segsum.binned_minmax_batched(mvals, mbins, m_bins),
                                  lambda: segsum.binned_minmax_batched_plain(mvals, mbins,
                                                                             m_bins)),
        "table_lookup_batched": (lambda: segsum.table_lookup_batched(table, tbins),
                                 lambda: segsum.table_lookup_batched_plain(table, tbins)),
    }


def concurrent_shard_checks(per_shard: list, dev, reps: int = 3) -> dict:
    """Kernels 1-5 launched from one host thread a shard, each on a stream
    of its own on ``dev``, at once, on that shard's recorded arguments,
    ``reps`` times each; every result held to its plain version (the sums
    within ``check_sums``' bound, the rest bit-equal). Returns name -> the
    largest |kernel - plain| over shards and repetitions."""
    from concurrent.futures import ThreadPoolExecutor

    calls = [shard_kernel_calls(a) for a in per_shard]
    streams = [torch.cuda.Stream(dev) for _ in per_shard]
    sync()
    errs = {}
    for name in calls[0]:
        def launch(i):
            with torch.cuda.device(dev), torch.cuda.stream(streams[i]):
                return [calls[i][name][0]() for _ in range(reps)]

        with ThreadPoolExecutor(len(calls)) as pool:
            got = list(pool.map(launch, range(len(calls))))
        sync()
        errs[name] = 0.0
        for i, outs in enumerate(got):
            want = calls[i][name][1]()
            for out in outs:
                if name == "binned_sum_cols_batched":
                    check_sums(out, want, *per_shard[i][name], f"{name} shard {i} (dp shards)")
                elif not agree(out, want):
                    raise AssertionError(f"{name} from shard {i}'s thread and stream != plain "
                                         "(dp shards)")
                errs[name] = max(errs[name], max_abs_err(out, want))
    return errs


def same_plate(runs: dict, ref: str, base: dict, what: str) -> None:
    """Every run's states bit-equal to ``ref``'s: profile columns (NaN
    equal), every segment step's labels, tracker states."""
    from aliby_tpu_torch.engine.core import profile_columns

    want_entries = runs[ref][0]
    segs = [n for n in base["steps"] if n.startswith("segment")]
    tracks = [n for n in base["steps"] if n.startswith("track")]
    for tag, (entries, *_) in runs.items():
        for e, w in zip(entries, want_entries):
            if not same_columns(profile_columns(e["state"], e["pipeline"]),
                                profile_columns(w["state"], w["pipeline"])):
                raise AssertionError(f"{what} {tag}: {e['pos']['key']}'s profile differs from "
                                     f"{ref}'s")
            for seg in segs:
                a, b = e["state"]["data"][seg], w["state"]["data"][seg]
                if len(a) != len(b) or not all(np.array_equal(x, y) for ta, tb in zip(a, b)
                                               for x, y in zip(ta, tb)):
                    raise AssertionError(f"{what} {tag}: {e['pos']['key']}'s {seg} differs")
            for tr in tracks:
                if not same_tracker_states(e["state"], w["state"], tr):
                    raise AssertionError(f"{what} {tag}: {e['pos']['key']}'s {tr} differs")


def shard_launches(runs: dict, ref: str, meshes: dict, n_pos: int, what: str) -> None:
    """Each run's shards: the five kernels launched in every shard that held
    positions (``min(dp, positions)`` of them; the others launched nothing),
    each such shard's launches those of the dp = 1 run ``ref`` (a call
    launches what it launches whatever its batch, and each shard makes one
    call a chunk, as dp = 1 does), and the shards' sum the run's counters."""
    want = runs[ref][1]
    for tag, (_, launches, shards, *_) in runs.items():
        dp = 1 if meshes[tag] is None else len(meshes[tag].dp_devices)
        active = [sh for sh in shards if any(sh.values())]
        if len(active) != min(dp, n_pos) or any(sh != want for sh in active):
            raise AssertionError(f"{what} {tag}: shard launches {shards}, a dp = 1 run {want}")
        summed = {k: sum(sh[k] for sh in shards) for k in launches}
        missing = [k for k, n in launches.items() if n <= 0]
        if summed != launches or missing:
            raise AssertionError(f"{what} {tag}: shard launches {shards}, the run's {launches}")


def multi_device_phase(dev) -> dict:
    """Phase 10: several devices. (a) Example 04's path and a tracked plate
    through ``run_positions_mesh_states`` on ``make_mesh(devices=["cuda:0"]
    * 2)`` (two shards on one card, each on its own stream) and, with more
    than one card, on ``make_mesh()``, bit-equal to dp = 1; (b) the sharded
    train step at the flagship widths in 4 gloo ranks on cuda:0 (dp = 2,
    sp = 2) against the one-process step; (c) the sp forward of the bundled
    flagship at 1080^2 (544 + 536 rows) in f32 and bf16 against the
    one-process forward. Returns (the phase's numbers, the "(dp shards)"
    kernel rows)."""
    import tempfile

    from aliby_tpu_torch.io import zarrlite
    from aliby_tpu_torch.io.dataset import DatasetDir, DatasetZarr
    from aliby_tpu_torch.parallel.mesh import make_mesh
    from aliby_tpu_torch.test_data import cellpainting_movie, get_dataset, get_dataset_path

    stats = {"card": card()}
    tmp = tempfile.TemporaryDirectory(prefix="aliby_multi_")
    first = "cuda:0" if dev.type == "cuda" else "cpu"
    meshes = {"dp1": None, "dp2 one card": make_mesh(devices=[first] * 2)}
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        meshes["every card"] = make_mesh()

    # (a) example 04: the TIFF crops through the mesh
    t_a = time.perf_counter()
    entry = get_dataset("crop_cellpainting_256")
    positions = DatasetDir(get_dataset_path(entry["name"]), regex=entry["regex"],
                           capture_order=entry["capture_order"]).get_position_ids()
    base = example04_pipeline()
    runs = mesh_plate_runs("example 04", base, positions, tmp.name, meshes, dev,
                           regex=entry["regex"], capture_order=entry["capture_order"])
    same_plate(runs, "dp1", base, "example 04")
    shard_launches(runs, "dp1", meshes, len(positions), "example 04")
    stats["example04"] = {tag: {"s": r[3], "fields_per_s": len(positions) / r[3],
                                "launches": r[1], "shards": r[2]} for tag, r in runs.items()}
    # a tracked plate: uneven shards (2 + 1 positions), chunks of 2 tps, one
    # position alone past the fused step's initial width of 64 labels
    n_pos, ntps, size, chunk = MULTI_PLATE
    store = os.path.join(tmp.name, "plate.zarr")
    for p, n_cells in enumerate(MULTI_PLATE_CELLS):
        movie = cellpainting_movie(1, ntps, size, seed=40 + p, n_cells=n_cells)
        zarrlite.write_array(os.path.join(store, f"pos{p}"), movie[0],
                             chunks=(1, 1, 1, size, size), compressor="zlib")
    plate = DatasetZarr(store).get_position_ids()
    tracked = example04_pipeline(ntps)
    recs = mesh_call_recorders(ShardRecorder)
    runs = mesh_plate_runs("tracked plate", tracked, plate, tmp.name, meshes, dev,
                           recorders={"dp2 one card": list(recs.values())},
                           capture_order="TCZYX", chunk=chunk)
    same_plate(runs, "dp1", tracked, "tracked plate")
    shard_launches(runs, "dp1", meshes, n_pos, "tracked plate")
    lmax = [max(int(np.max(m)) for seg in ("segment_nuclei", "segment_cell")
                for m in e["state"]["data"][seg]) for e in runs["dp1"][0]]
    if not (max(lmax[:2]) <= 64 < lmax[2]):
        raise AssertionError(f"tracked plate: largest labels {lmax}; only the last position "
                             "(the second shard's) should pass 64")
    for tag, r in runs.items():
        if r[4] != {"cap": 256, "u8": max(lmax) <= 255}:
            raise AssertionError(f"tracked plate {tag}: state after {r[4]}")
    for tag in runs:
        same_saves(os.path.join(tmp.name, tag, "steps"), os.path.join(tmp.name, "dp1", "steps"))
    stats["tracked_plate"] = {tag: {"s": r[3], "field_tps_per_s": n_pos * ntps / r[3],
                                    "launches": r[1], "shards": r[2]} for tag, r in runs.items()}
    log(f"[multi] tracked plate: largest labels per position {lmax}; every mesh bit-equal to "
        f"dp = 1 (profiles, labels, tracks, saves); both shards widened at once")
    stats["a_s"] = time.perf_counter() - t_a
    tmp.cleanup()
    rows = dp_shard_rows(recs, runs["dp2 one card"][1], torch.device(first))
    stats.update(ranks_part(dev, first))
    log(f"[multi] (a) {stats['a_s']:.1f} s, (b)+(c) {stats['bc_s']:.1f} s (ranks "
        f"{stats['ranks_s']:.1f} s); {stats['card']}")
    return stats, rows


def dp_shard_rows(recs: dict, launches: dict, dev) -> dict:
    """Kernels 1-5 at the tracked plate's shard shapes (recorded per shard
    stream in its dp = 2 run on one card): launched from two threads at
    once, each shard's on a stream of its own, and held to plain
    (:func:`concurrent_shard_checks`); then timed at the larger shard's
    shapes as rows "... (dp shards)" of the ``kernels`` line, with the
    launches of that run."""
    streams = {frozenset(r.by_stream) for r in recs.values()}
    if len(streams) != 1 or len(next(iter(streams))) != 2:
        raise AssertionError("the dp = 2 run's kernels were not recorded on two shard streams: "
                             + str({k: len(r.by_stream) for k, r in recs.items()}))
    per_shard = sorted(({k: r.by_stream[st] for k, r in recs.items()} for st in next(iter(streams))),
                       key=lambda a: -a["successor_prop"][0].shape[0])
    shapes = [tuple(a["successor_prop"][0].shape) for a in per_shard]
    errs = concurrent_shard_checks(per_shard, dev)
    log(f"[report] kernels 1-5 from two shard threads, each on its own stream, at once, at the "
        f"tracked plate's shard shapes (successor_prop {shapes}): every result equal to plain "
        f"(the sums within the summation bound), max |kernel - plain| {errs}")
    log(f"[report] kernels 1-5 at the larger shard's shapes (launches: the tracked plate's dp = 2 "
        f"run on one card; {card()}):")
    rows = {}
    for name, row in measure_kernels(per_shard[0], launches).items():
        row.update(name=name + DP_SHARDS, max_abs_err=max(row["max_abs_err"], errs[name]),
                   shard_shapes=[list(a[name][0].shape) for a in per_shard])
        rows[name + DP_SHARDS] = row
    return rows


def ranks_part(dev, first: str) -> dict:
    """Phase 10 (b) and (c): 4 gloo ranks on ``first`` (dp 2 x sp 2), the
    sharded train step and the sp forward, against one process on
    ``dev``."""
    from aliby_tpu_torch.extract.tolerances import (
        GRAD_FLOOR_ATOL,
        GRAD_RTOL,
        LOSS_RTOL,
        gradient_excess,
        update_excess,
        within_model_tolerance,
    )
    from aliby_tpu_torch.models import training
    from aliby_tpu_torch.models.cpnet import tf32_off
    from aliby_tpu_torch.models.unet import ConvBlock
    from aliby_tpu_torch.parallel import dryrun
    from aliby_tpu_torch.parallel.mesh import sp_rows

    stats = {}
    t_b = time.perf_counter()
    ranks = dryrun.spawn_ranks([
        {"name": "train", "kind": "train", "args": dict(MULTI_TRAIN)},
        {"name": "f32", "kind": "forward", "args": dict(MULTI_FORWARD, dtype="float32")},
        {"name": "bf16", "kind": "forward", "args": dict(MULTI_FORWARD, dtype="bfloat16")},
    ], [first] * 4, dp=2, sp=2, backend="gloo")
    stats["ranks_s"] = time.perf_counter() - t_b
    # the one-process references on the same card
    feats, batch, size, steps = (MULTI_TRAIN[k] for k in ("feats", "batch", "size", "steps"))
    initial = dryrun.make_model(feats, "float32", None, 0, "cpu").state_dict()
    model = dryrun.make_model(feats, "float32", None, 0, dev)
    optimizer, scheduler = training.adamw(model.parameters(), MULTI_TRAIN["lr"])
    first = []
    optimizer.register_step_pre_hook(lambda *a: first.append(
        {n: p.grad.detach().cpu().numpy() for n, p in model.named_parameters()}))
    step = training.make_train_step(model, optimizer, scheduler)
    rng = np.random.default_rng(0)
    want, one_s = [], []
    for _ in range(steps):
        b = training.synthetic_batch(rng, batch, size, device=dev)
        sync()
        t0 = time.perf_counter()
        m = step(b)
        sync()
        one_s.append(time.perf_counter() - t0)
        want.append({k: float(v) for k, v in m.items()})
    got = ranks[0]["train"]["metrics"]
    for r in ranks[1:]:
        if r["train"]["metrics"] != got or any(
                not torch.equal(p, ranks[0]["train"]["params"][k])
                for k, p in r["train"]["params"].items()):
            raise AssertionError("sharded train step: the ranks' parameters differ")
    for i, (g, w) in enumerate(zip(got, want)):
        for k in w:
            if abs(g[k] - w[k]) > LOSS_RTOL * abs(w[k]):
                raise AssertionError(f"sharded train step {i}: {k} {g[k]} vs one process {w[k]}")
    # the first batch's global gradient, at the f32 rule of one process
    # against JAX on the CPU (the ranks' blocks are other shapes, for which
    # cuDNN may pick other algorithms)
    rtol = GRAD_RTOL
    grads = gradient_excess({k: v.numpy() for k, v in ranks[0]["train"]["grads"].items()},
                            first[0], rtol, GRAD_FLOOR_ATOL)
    worst_grad = max(grads.items(), key=lambda kv: kv[1][0])
    if worst_grad[1][0] > 1:
        raise AssertionError(f"sharded train step: first gradient beyond the rule at {worst_grad}")
    # a conv0 bias whose GroupNorm holds one channel a group is removed by
    # it: its gradient is rounding only (none at the flagship widths)
    noise = frozenset(f"{name}.conv0.bias" for name, m in model.named_modules()
                      if isinstance(m, ConvBlock) and m.norm1.num_groups == m.conv0.bias.numel())
    excess = update_excess(ranks[0]["train"]["params"],
                           {k: v.cpu() for k, v in model.state_dict().items()}, initial,
                           MULTI_TRAIN["lr"] * steps, noise=noise)
    worst = max(excess.items(), key=lambda kv: kv[1])
    if worst[1] > 1:
        raise AssertionError(f"sharded train step: parameters beyond the rule at {worst}")
    heat = [r["train"]["diffuse_heat"] for r in ranks]
    shard_ms = [1e3 * statistics.median(r["train"]["seconds"][1:]) for r in ranks]
    stats["train"] = {"losses": [g["loss"] for g in got], "one_process_losses":
                      [w["loss"] for w in want], "worst_update": worst,
                      "worst_first_gradient": (worst_grad[0], worst_grad[1][0]),
                      "ms_step_2x2": max(shard_ms), "ms_step_one_process":
                      1e3 * statistics.median(one_s[1:]), "diffuse_heat_launches": heat}
    log(f"[multi] (b) sharded train step, widths {feats}, {batch} x {size}^2 f32, dp 2 x sp 2 "
        f"gloo ranks on one card: losses {[round(g['loss'], 6) for g in got]} vs one process "
        f"{[round(w['loss'], 6) for w in want]}; first gradient: worst {worst_grad[0]} at "
        f"{worst_grad[1][0]:.3g} of rtol {rtol}; worst update (L2) {worst[0]} at "
        f"{worst[1]:.3g} of its limit; parameters the same bits on all 4 ranks; diffuse_heat launches per rank "
        f"{heat}; ms a step (steps 2-3, median) {max(shard_ms):.1f} (slowest rank) vs one "
        f"process {stats['train']['ms_step_one_process']:.1f}")
    # (c) the sp forward at 1080^2
    x = torch.from_numpy(dryrun.forward_inputs(MULTI_FORWARD["batch"], MULTI_FORWARD["size"],
                                               MULTI_FORWARD["seed"])).to(dev)
    rows = sp_rows(MULTI_FORWARD["size"], 2, 8)
    for dtype in ("f32", "bf16"):
        blocks = [r[dtype]["pred"] for r in ranks]
        if sorted(b.shape[1] for b in blocks) != sorted(rows * 2):
            raise AssertionError(f"sp forward {dtype}: blocks of {[b.shape for b in blocks]}")
        pred = dryrun.assemble([r[dtype] for r in ranks], MULTI_FORWARD["batch"],
                               MULTI_FORWARD["size"])
        net = dryrun.make_model(FLAGSHIP, "float32" if dtype == "f32" else "bfloat16",
                                "bundled", 0, dev).eval()
        with torch.no_grad(), (tf32_off() if dtype == "f32" and dev.type == "cuda"
                               else contextlib.nullcontext()):
            sync()
            t0 = time.perf_counter()
            one = net(x).float()
            sync()
            one_ms = (time.perf_counter() - t0) * 1e3
        one = one.cpu().numpy()
        err = float(np.abs(pred.numpy() - one).max())
        if dtype == "f32":
            ok = np.allclose(pred.numpy(), one, rtol=1e-4, atol=1e-4)
        else:
            ok = within_model_tolerance(pred.numpy(), one, "bf16")
        if not ok:
            raise AssertionError(f"sp forward {dtype}: max |diff| {err} beyond the rule")
        sp_ms = max(r[dtype]["seconds"] for r in ranks) * 1e3
        stats[f"forward_{dtype}"] = {"max_abs_err": err, "scale": float(np.abs(one).max()),
                                     "ms_sp2": sp_ms, "ms_one_process": one_ms}
        log(f"[multi] (c) sp forward {dtype}, {MULTI_FORWARD['batch']} x "
            f"{MULTI_FORWARD['size']}^2 in blocks of {rows} rows: max |diff| "
            f"{err:.3g} (largest |value| {np.abs(one).max():.3g}); ms {sp_ms:.1f} (slowest "
            f"rank, 4 on one card) vs one process {one_ms:.1f}")
    stats["bc_s"] = time.perf_counter() - t_b
    if min(heat) <= 0:  # every rank renders its targets on the card
        raise AssertionError(f"sharded train step: diffuse_heat launches per rank {heat}")
    return stats


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from aliby_tpu_torch.extract import features, reductions
    from aliby_tpu_torch.kernels import _build
    from aliby_tpu_torch.models import flows
    from aliby_tpu_torch.models.segment import dispatch_segmenter, segment_grouped
    from aliby_tpu_torch.ops import segsum, stencil
    from aliby_tpu_torch.test_data import cellpainting_fields, cellpainting_large_field

    dev = torch.device("cuda")
    log("torch", torch.__version__, "cuda", torch.version.cuda, "device",
        torch.cuda.get_device_name(0), "count", torch.cuda.device_count())
    wrappers = {
        "successor_prop": stencil.successor_prop,
        "diffuse_heat": stencil.diffuse_heat,
        "binned_sum_cols_batched": segsum.binned_sum_cols_batched,
    }

    phase_t = {"start": time.perf_counter()}

    def phase_done(name):
        now = time.perf_counter()
        log(f"[time] phase {name}: {now - phase_t.pop('last', phase_t['start']):.1f} s "
            f"({now - phase_t['start']:.1f} s since the start)")
        phase_t["last"] = now

    # ---------------------------------------------------------------- 1 build
    t0 = time.perf_counter()
    paths = _build.build()
    log(f"[build] {len(paths)} libraries in {time.perf_counter() - t0:.1f} s")
    for name, text in _build.BUILD_LOGS.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {name}: {line.strip()}")

    phase_done("1 (build)")
    if sys.argv[1:] == ["--phase", "8"]:  # a quick run of one phase alone
        training_phase(dev)
        phase_done("8 (training)")
        log("chip_smoke: phase 8 alone; no result line")
        return 0
    if sys.argv[1:] == ["--phase", "10"]:
        multi_device_phase(dev)
        phase_done("10 (several devices)")
        log("chip_smoke: phase 10 alone; no result line")
        return 0

    # -------------------------------------------------------------- 2 kernels
    kernel_checks(np.random.default_rng(0), dev)
    phase_done("2 (kernels)")

    # ------------------------------------------------------- 3 slice 1 (segmentation)
    pixels = np.concatenate(cellpainting_fields(8, 256, seed=7))  # (8, 5, 1, 256, 256)
    nuclei = dispatch_segmenter("cellpose", 0, second_channel=3)
    cell = dispatch_segmenter("cellpose", 3, second_channel=0)
    if nuclei.engine is not cell.engine:
        raise AssertionError("nuclei and cell must share one engine")
    segment_grouped([nuclei, cell], pixels)  # warm-up (cuDNN plans, kernel loads)
    sync()

    recorders = [Recorder(flows, "successor_prop"), Recorder(flows, "diffuse_heat"),
                 Recorder(reductions, "binned_sum_cols_batched")]
    for w in wrappers.values():
        w.launches = 0
    with recording(recorders):
        t0 = time.perf_counter()
        run1 = segment_grouped([nuclei, cell], pixels)
        sync()
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
        sync()
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
    with recording(big_recorders):
        t0 = time.perf_counter()
        big_masks = segment_grouped([nuclei, cell], big)
        sync()
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

    # ------------------------------------- 3 slices 2 and 3 (the fused step, two banks)
    # build_pipeline_steps' pipelines segment without a second channel
    plain_seg = segment_grouped([dispatch_segmenter("cellpose", 0),
                                 dispatch_segmenter("cellpose", 3)], pixels)
    step, _, ex01_launches, ex01_stats = fused_checks("example-01", pixels, plain_seg, reps=3,
                                                      profile=False)
    ex01_stats.update(fused_wide_pass("example-01", step, big))
    step, fused_rec, fused_launches, fused_stats = fused_checks("default bank", pixels, plain_seg,
                                                                reps=5, profile=True)
    fused_stats.update(fused_wide_pass("default bank", step, big))
    # the wide pass's costes histogram: cap 256, (256 + 1) * 257 bins
    with Recorder(features, "binned_sum_cols_batched", lambda v, b, n: n == 257 * 257) as wide:
        step.fused(big)
    if wide.args is None:
        raise AssertionError("the 1080x1080 wide pass made no costes histogram of 66,049 bins")

    # -------------------------------------------------- 3 f32 on the card vs the CPU
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
    gpu_big = segment_grouped([dispatch_segmenter("cellpose", 0, second_channel=3, **f32),
                               dispatch_segmenter("cellpose", 3, second_channel=0, **f32)], big)
    bf16_vs_f32_labels(run1, gpu, "8 fields x 2 objects")
    bf16_vs_f32_labels(big_masks, gpu_big, "the 1080x1080 field x 2 objects")
    raster_checks(plain_seg, pixels, dev)
    for what in FUSED_PATHS:
        fused_gpu_vs_cpu(what, pixels)

    phase_done("3 (slices 1-3)")

    # --------------------------------------------------------------- 4 report
    log("[report] slice 1 (segmentation) kernels on its own inputs:")
    qc = measure_kernels({n: r.args for n, r in zip(SLICE1_KERNELS, recorders)}, launches)
    log("[report] the same, on the 1080x1080 field's inputs:")
    qc_big = measure_kernels({n: r.args for n, r in zip(SLICE1_KERNELS, big_recorders)},
                             big_launches)
    log("[report] the default-bank step's kernels on its own inputs (launches: one step; the "
        f"example-01 step launched {ex01_launches}):")
    rows = measure_kernels(fused_rec, fused_launches)
    log("[report] the costes histogram (binned_sum_cols_batched, 6 columns, "
        "(cap + 1) * 257 bins):")
    n_sum = fused_launches["binned_sum_cols_batched"]
    sum_rows = [qc["binned_sum_cols_batched"], qc_big["binned_sum_cols_batched"],
                rows["binned_sum_cols_batched"], binned_sum_row(*fused_rec["costes histogram"], n_sum)]
    log("[report] the costes histogram of the 1080x1080 field's wide pass (cap 256, 66,049 bins; "
        "launches: one default-bank step on 8 fields):")
    sum_rows.append(binned_sum_row(*wide.args, n_sum))
    log("[report] the default bank's other shapes: a zernike entry's first column group, the "
        "radial distribution's (label, ring) bins, texture's range, the per-channel lookup:")
    sum_rows.append(binned_sum_row(*fused_rec["zernike group"], n_sum))
    sum_rows.append(binned_sum_row(*fused_rec["radial rings"], n_sum))
    measure_kernels({"binned_minmax_batched": fused_rec["texture range"],
                     "table_lookup_batched": fused_rec["channel lookup"]}, fused_launches)
    rows["segment_sum_matmul"] = segment_sum_row(np.random.default_rng(6), dev,
                                                 fused_launches["segment_sum_matmul"])
    log("[report] sum kernels against index_add_ in this call (kernel ms / library ms): " + ", ".join(
        f"{tuple(r['shape'])} {r['ms'] / r['library_ms']:.3f}" for r in sum_rows + [
            rows["segment_sum_matmul"]]) + " (the last: segment_sum_matmul, on no path)")
    slower = [tuple(r["shape"]) for r in sum_rows if r["ms"] > r["library_ms"]]
    if slower:
        raise AssertionError(f"main-path sums slower than index_add_ in this call at {slower}")
    sum_breakdown(fused_rec["costes histogram"], wide.args, SEGMENT_SUM_SHAPE, dev)
    phase_done("4 (report)")

    # --------------------------------------------------------------- 5 runner
    rows[TRACKER_ROW] = runner_phase(dev)
    if rows[TRACKER_ROW]["ms"] > rows[TRACKER_ROW]["library_ms"]:
        log("[report] the trackers' intersection count is slower than index_add_ in this call")
    phase_done("5 (runner)")

    # ------------------------------------------------------------ 6 yeast path
    rows.update(yeast_phase(dev))
    phase_done("6 (yeast path)")

    # ------------------------------------------------- 7 model zoo and server
    zoo, zoo_rows = zoo_phase(dev)
    rows.update(zoo_rows)
    phase_done("7 (model zoo and server)")

    # ---------------------------------------------------------------- 8 training
    training, train_rows = training_phase(dev)
    rows.update(train_rows)
    phase_done("8 (training)")

    # ------------------------------------------------- 9 example 01 from a TIFF plate
    plate, plate_rows = tiff_plate_phase(dev)
    rows.update(plate_rows)
    phase_done("9 (example 01 from a TIFF plate)")

    # ------------------------------------------------------ 10 several devices
    multi, multi_rows = multi_device_phase(dev)
    rows.update(multi_rows)
    phase_done("10 (several devices: example 04, the sharded train step, the sp forward)")

    log(json.dumps({"slice": {"fields_per_s": fields_s, "batch_ms": t_med * 1e3,
                              "objects": counts, "field_1080_ms": t_big * 1e3},
                    "fused example-01": ex01_stats, "fused default bank": fused_stats,
                    "zoo": zoo, "training": training, "tiff plate": plate,
                    "several devices": multi}))
    print(json.dumps({"kernels": [rows[name] for name in REPLACES]}), flush=True)
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
