"""Many positions through one fused call a chunk, on one GPU (counterpart
of ``aliby_tpu/parallel/pipeline_mesh.py``).

Per chunk of timepoints, every position's pixel block is stacked into one
flat tile batch and the whole fused per-tp step (segmentation and every
extraction tree, ``engine/fused.py``) runs as one call on ``device``; stitch
trackers run as one ``stitch_movie`` over all positions' tiles a chunk.
Host tiling/IO runs in a thread pool and overlaps the device; results are
split back per position and go through the same ``CompiledStep``
bookkeeping, so states, saves and profiles are those of the per-position
runner. The reference's ``mesh`` becomes one ``device`` (data parallelism
1, so no padding rows); several GPUs are ROADMAP queue 1, item 7.

Positions must share the fused-eligible pipeline shape (the same tile count
in every position); an ineligible pipeline falls back to ``run_positions``.
"""

from __future__ import annotations

import logging
import os
import time
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from aliby_tpu_torch.device import resolve_device
from aliby_tpu_torch.engine.compiled import try_compile
from aliby_tpu_torch.engine.core import finalize_position, validate_pipeline
from aliby_tpu_torch.parallel.positions import run_positions, stamp_image_kwargs
from aliby_tpu_torch.utils.timer import StepTimer

logger = logging.getLogger("aliby_tpu_torch")

TIMING_KEYS = ("io_wait", "stack", "device_put", "dispatch", "collect", "bookkeep", "finalize")


def plan_calls(n_pos: int, F: int, ntps: int, chunk: int | None, max_fields: int | None,
               movie_capable: bool) -> tuple[int, int]:
    """``(positions a call, timepoints a call)`` of the mesh path for
    ``n_pos`` positions of ``F`` tiles a timepoint.

    ``chunk=None`` sizes the timepoints: 1 when a tracker has no whole-movie
    form, else up to 8 within the call's fields (``max_fields``, or ~32
    tiles when it is None), at least two chunks when ntps allows, and
    chunks of balanced size. With ``max_fields`` the positions are split
    into balanced groups whose calls fit it, and a chunk that does not fit
    even for one position is shortened (the results do not depend on the
    batch)."""
    if chunk is None:
        if ntps <= 1 or not movie_capable:
            C = 1
        else:
            limit = 32 if max_fields is None else max_fields
            c0 = max(1, min(8, ntps, limit // max(1, n_pos * F)))
            C = -(-ntps // max(2, -(-ntps // c0)))
    else:
        C = max(1, int(chunk))
        if C > 1 and not movie_capable:
            logger.warning("chunk=%d requested but a tracker lacks a whole-movie form; "
                           "running chunk=1", C)
            C = 1
    if max_fields is None:
        return n_pos, C
    if C * F > max_fields:
        logger.warning("chunk=%d of %d tiles exceeds the %d fields a call holds on the device; "
                       "running chunk=%d", C, F, max_fields, max(1, max_fields // F))
        C = max(1, max_fields // F)
    G = max(1, min(n_pos, max_fields // (C * F)))
    n_groups = -(-n_pos // G)
    return -(-n_pos // n_groups), C


def run_positions_mesh_states(base_pipeline: dict, positions: Sequence[dict],
                              output_path: str | Path, regex: str | None = None,
                              capture_order: str | None = None, device=None,
                              overwrite: bool = False, chunk: int | None = None):
    """Run every timepoint of every position through the batched fused step;
    returns ``(entries, timing)``, or ``None`` when the pipeline is not
    fused-eligible. Each entry holds a position's ``pos``, ``pipeline``,
    ``tiler`` and ``state`` (not finalized: no parquet is written, so this
    needs no pyarrow). ``timing`` is the dispatch thread's blocking time
    per phase when ``ALIBY_MESH_TIMING`` is set, else None.

    ``chunk`` batches that many timepoints into each fused call (the
    movie path's chunk): a chunk's ``chunk x positions x tiles`` block runs
    as one call and stitch trackers carry their state across chunks.
    ``chunk=None`` sizes it (:func:`plan_calls`). On the card a call holds
    at most :meth:`~aliby_tpu_torch.engine.compiled.CompiledStep.max_fields`
    fields: a plate that does not fit runs as groups of positions, one
    group after another.
    """
    from aliby_tpu_torch.pipe import init_step

    device = resolve_device(device)
    output_path = Path(output_path)
    entries = []
    for pos in positions:
        pipeline = stamp_image_kwargs(base_pipeline, pos, regex=regex, capture_order=capture_order)
        validate_pipeline(pipeline)
        if (output_path / "profiles" / f"{pos['key']}.parquet").exists() and not overwrite:
            logger.info("Skipping %s", pos["key"])
            continue
        tiler = init_step("tile", pipeline["steps"]["tile"], {}, device=device)
        entries.append({"pos": pos, "pipeline": pipeline, "tiler": tiler})
    timing = {k: 0.0 for k in TIMING_KEYS} if os.environ.get("ALIBY_MESH_TIMING") else None
    if not entries:
        return entries, timing
    compiled = try_compile(entries[0]["pipeline"], entries[0]["tiler"], init_step, device=device)
    if compiled is None:
        return None
    for e in entries:
        e["state"] = {"tps": {n: 0 for n in e["pipeline"]["steps"]}, "data": {},
                      "fn": {"tile": e["tiler"]}, "timer": StepTimer()}
    ntps = base_pipeline.get("ntps", 1)

    def _timed(key, fn, *a, **kw):
        if timing is None:
            return fn(*a, **kw)
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            timing[key] += time.perf_counter() - t0

    def done(value) -> Future:
        f = Future()
        f.set_result(value)
        return f

    def run_group(group, C, first):
        """Every timepoint of the positions ``group`` in calls of ``C``
        timepoints; ``first`` is the group's first tile fetch, if made."""
        n_pos = len(group)

        def submit_io(tp):
            # one future per position, not pool.map inside pool.submit (a
            # nested map can deadlock a bounded pool)
            return [done(first) if tp == 0 and i == 0 and first is not None
                    else pool.submit(lambda e=e: e["tiler"].run_tp(tp))
                    for i, e in enumerate(group)]

        def fetch_tp(futs):
            """Block on one tp's IO: (per-position tile results, the (P*F,
            ...) pixel block, F)."""
            tile_results = [f.result() for f in futs]
            blocks = []
            for tr in tile_results:
                pb = np.asarray(tr.pop("pixels"), np.float32)
                blocks.append(pb[0] if pb.ndim == 6 else pb)
            n_tiles = [pb.shape[0] for pb in blocks]
            if len(set(n_tiles)) != 1:
                raise ValueError(f"batching positions needs equal tile counts; got {n_tiles}")
            return tile_results, np.concatenate(blocks, axis=0), n_tiles[0]

        def bookkeep_chunk(ch, per_tp_tiles, out, tracked):
            """Split one chunk's results back per (tp, position) and run the
            CompiledStep bookkeeping, each position in its own thread."""
            tc, PF = len(ch), n_pos * F
            overrides = (compiled.tracker_overrides(tracked, tc, n_pos, F) if tracked
                         else [[None] * n_pos for _ in range(tc)])

            def ingest(ie):
                i, e = ie
                steps_dir = output_path / "steps" / e["pos"]["key"]
                for k, tp in enumerate(ch):  # tps in order within a position
                    sl = slice(k * PF + i * F, k * PF + (i + 1) * F)
                    per_pos = {
                        "labels": [lab[sl] for lab in out["labels"]],
                        "features": [[(names, arr[:, sl]) for names, arr in per_obj]
                                     for per_obj in out["features"]],
                    }
                    compiled.run_tp(tp, e["tiler"], e["state"], e["pipeline"], steps_dir,
                                    tile_result=per_tp_tiles[k][i], out=per_pos,
                                    tracker_override=overrides[k][i])

            list(pool.map(ingest, enumerate(group)))

        scan_tracker = C > 1 and bool(compiled.tracker_specs)
        chunks = [list(range(i, min(i + C, ntps))) for i in range(0, ntps, C)]
        io_futs = {tp: submit_io(tp) for tp in chunks[0]}
        fetched = {}
        pending = None  # (chunk tps, per-tp tiles, handle, tracked) awaiting readback
        carry = None
        for ci, ch in enumerate(chunks):
            per_tp_tiles, blocks = [], []
            for tp in ch:
                if tp not in fetched:
                    fetched[tp] = _timed("io_wait", fetch_tp, io_futs.pop(tp))
                tr, blk, f_tp = fetched.pop(tp)
                if f_tp != F:
                    raise ValueError(f"tile count changed across tps: {f_tp} != {F}")
                per_tp_tiles.append(tr)
                blocks.append(blk)
            flat = _timed("stack", np.concatenate, blocks, axis=0)  # (tc*P*F, C, Z, Y, X)
            flat = _timed("device_put", lambda: torch.from_numpy(flat).to(device))
            # the fused call reads the realised label count back after
            # segmentation (its sticky width), then queues the trees; this
            # chunk's tracking is queued behind them, and the previous
            # chunk's readback and bookkeeping run while the device works
            handle = _timed("dispatch", compiled.fused.dispatch, flat)
            tracked = None
            if scan_tracker:
                # the previous chunk is not ingested yet: its tracker state
                # comes from its own device tensors
                tracked = compiled.track_chunk(compiled.fused.device_labels(handle), n_pos, F,
                                               len(ch), carry=carry)
                carry = compiled.chunk_carry(tracked, base_pipeline)
            if ci + 1 < len(chunks):
                for tp in chunks[ci + 1]:
                    io_futs[tp] = submit_io(tp)
            if pending is not None:
                p_ch, p_tiles, p_handle, p_tracked = pending
                out = _timed("collect", compiled.fused.collect, p_handle)
                _timed("bookkeep", bookkeep_chunk, p_ch, p_tiles, out, p_tracked)
            pending = (ch, per_tp_tiles, handle, tracked)
        p_ch, p_tiles, p_handle, p_tracked = pending
        out = _timed("collect", compiled.fused.collect, p_handle)
        _timed("bookkeep", bookkeep_chunk, p_ch, p_tiles, out, p_tracked)

    pool = ThreadPoolExecutor(max_workers=min(8, max(2, len(entries))))
    try:
        # the first position's first fetch gives the tiles a timepoint and
        # their size, which the plan of calls needs
        first = _timed("io_wait", entries[0]["tiler"].run_tp, 0)
        shape = np.shape(first["pixels"])
        F, field_pixels = shape[-5], shape[-2] * shape[-1]
        G, C = plan_calls(len(entries), F, ntps, chunk, compiled.max_fields(field_pixels),
                          compiled.movie_capable())
        if G < len(entries):
            logger.info("mesh: %d positions in groups of %d, chunks of %d tps", len(entries),
                        G, C)
        for g0 in range(0, len(entries), G):
            run_group(entries[g0:g0 + G], C, first if g0 == 0 else None)
    finally:
        pool.shutdown(wait=False)
    return entries, timing


def run_positions_mesh(base_pipeline: dict, positions: Sequence[dict], output_path: str | Path,
                       regex: str | None = None, capture_order: str | None = None, device=None,
                       overwrite: bool = False, chunk: int | None = None) -> dict[str, tuple]:
    """Run every position through the batched fused step on ``device``
    (:func:`run_positions_mesh_states`), then finalize each: profiles
    parquet, global steps. Returns {position_key: (profiles, post_results)}
    like ``run_positions``."""
    from aliby_tpu_torch.pipe import init_step

    device = resolve_device(device)
    ran = run_positions_mesh_states(base_pipeline, positions, output_path, regex=regex,
                                    capture_order=capture_order, device=device,
                                    overwrite=overwrite, chunk=chunk)
    if ran is None:
        logger.warning("pipeline not fused-eligible; falling back to threaded positions")
        return run_positions(base_pipeline, positions, output_path, regex=regex,
                             capture_order=capture_order, overwrite=overwrite, devices=[device])
    entries, timing = ran
    t_fin = time.perf_counter()
    with ThreadPoolExecutor(max_workers=min(8, max(2, len(entries)))) as pool:
        finalized = list(pool.map(
            lambda e: finalize_position(e["state"], e["pipeline"], e["pos"]["key"], output_path,
                                        init_step, post_state_hook=None, device=device),
            entries))
    results = {e["pos"]["key"]: prof for e, prof in zip(entries, finalized)}
    if timing is not None:
        timing["finalize"] = time.perf_counter() - t_fin
        logger.warning("mesh timing (dispatch-thread blocking, %d tps x %d pos): %s; "
                       "accounted %.3fs", base_pipeline.get("ntps", 1), len(entries),
                       " ".join(f"{k}={v:.3f}s" for k, v in timing.items()),
                       sum(timing.values()))
    return results
