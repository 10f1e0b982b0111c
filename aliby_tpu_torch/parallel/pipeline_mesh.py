"""Many positions through one fused call a chunk, over the dp devices of a
mesh (counterpart of ``aliby_tpu/parallel/pipeline_mesh.py``).

Per chunk of timepoints, the positions of a round are split into dp
contiguous groups, one a shard, and each shard's pixel block (all of the
chunk's timepoints and tiles of its positions) runs as one fused call
(segmentation and every extraction tree, ``engine/fused.py``) on its own
device, in its own host thread and stream
(:class:`~aliby_tpu_torch.engine.fused.ShardedStep`). The shards share one
sticky label width, decided from the largest label over all of them, as
the reference decides it on the global batch; stitch trackers run as one
``stitch_movie`` a shard over its positions' tiles, on the shard's own
device tensors. Nothing crosses devices but each shard's largest label.

The reference shards the flat (timepoint, position, tile) rows of one call
contiguously over dp and pads them to a multiple of dp by repeating row 0;
the port shards by groups of positions and pads nothing. The U-Net runs in
micro-batches fixed by the image size (``models/segment.CellposeTorch.
_forward``) and nothing else in the step depends on the batch, so the
results do not depend on the split: dp = 2 gives the bits of dp = 1. The
reference replicates the runner's work over ``sp``; the port runs it once
on the first device of each sp row (ROADMAP queue 3).

Host tiling/IO runs in a thread pool and overlaps the device; results are
split back per position and go through the same ``CompiledStep``
bookkeeping, so states, saves and profiles are those of the per-position
runner. Positions must share the fused-eligible pipeline shape (the same
tile count in every position); an ineligible pipeline falls back to
``run_positions`` over the mesh's dp devices.
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
from aliby_tpu_torch.engine.compiled import try_compile_sharded
from aliby_tpu_torch.engine.core import finalize_position, validate_pipeline
from aliby_tpu_torch.parallel.mesh import Mesh, even_split, make_mesh
from aliby_tpu_torch.parallel.positions import run_positions, stamp_image_kwargs
from aliby_tpu_torch.utils.timer import StepTimer

logger = logging.getLogger("aliby_tpu_torch")

TIMING_KEYS = ("io_wait", "stack", "dispatch", "collect", "bookkeep", "finalize")


def plan_calls(n_pos: int, F: int, ntps: int, chunk: int | None, max_fields: int | None,
               movie_capable: bool, dp: int = 1) -> tuple[int, int]:
    """``(positions a round, timepoints a call)`` of the mesh path for
    ``n_pos`` positions of ``F`` tiles a timepoint over ``dp`` shards; a
    round runs one call a shard, at once, each on at most
    ``ceil(positions / dp)`` positions.

    ``chunk=None`` sizes the timepoints: 1 when a tracker has no whole-movie
    form, else up to 8 within a call's fields (``max_fields``, or ~32
    tiles when it is None), at least two chunks when ntps allows, and
    chunks of balanced size. With ``max_fields`` (the fields that one
    shard's call may hold) the positions are split into balanced rounds
    whose calls fit it, and a chunk that does not fit even for one position
    is shortened (the results do not depend on the batch)."""
    per_call = -(-n_pos // max(1, dp))
    if chunk is None:
        if ntps <= 1 or not movie_capable:
            C = 1
        else:
            limit = 32 if max_fields is None else max_fields
            c0 = max(1, min(8, ntps, limit // max(1, per_call * F)))
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
    G = min(n_pos, max(1, min(per_call, max_fields // (C * F))) * max(1, dp))
    n_groups = -(-n_pos // G)
    return -(-n_pos // n_groups), C


def _dp_devices(mesh: Mesh | None, device) -> list[torch.device]:
    """The devices of the dp shards: the first device of each of the mesh's
    sp rows, or ``device`` alone (default ``cuda``)."""
    if mesh is not None and device is not None:
        raise ValueError("pass a mesh or a device, not both")
    if mesh is not None:
        return [resolve_device(d) for d in mesh.dp_devices]
    return [resolve_device(device)]


def _shard_max_fields(steps, field_pixels: int) -> int | None:
    """The fields one shard's call may hold: each card's
    ``CompiledStep.max_fields`` shared by the shards on that card (they run
    at once); ``None`` off the card."""
    devices = [s.device for s in steps]
    limits = []
    for step in {str(s.device): s for s in steps}.values():
        most = step.max_fields(field_pixels)
        if most is None:
            return None
        limits.append(max(1, most // devices.count(step.device)))
    return min(limits)


def _split_positions(n: int, dp: int) -> list[range]:
    """Contiguous groups of ``n`` positions over ``dp`` shards, the first
    groups one larger; empty groups for shards left without a position."""
    bounds = np.cumsum([0] + even_split(n, dp))
    return [range(bounds[i], bounds[i + 1]) for i in range(dp)]


def run_positions_mesh_states(base_pipeline: dict, positions: Sequence[dict],
                              output_path: str | Path, regex: str | None = None,
                              capture_order: str | None = None, mesh: Mesh | None = None,
                              device=None, overwrite: bool = False, chunk: int | None = None,
                              report: dict | None = None):
    """Run every timepoint of every position through the fused step, over
    the dp devices of ``mesh`` (or on ``device`` alone); returns ``(entries,
    timing)``, or ``None`` when the pipeline is not fused-eligible. Each
    entry holds a position's ``pos``, ``pipeline``, ``tiler`` and ``state``
    (not finalized: no parquet is written, so this needs no pyarrow).
    ``timing`` is the dispatch thread's blocking time per phase when
    ``ALIBY_MESH_TIMING`` is set, else None. With neither ``mesh`` nor
    ``device`` it runs on ``cuda``; a mesh may repeat a card
    (``make_mesh(devices=["cuda:0"] * 2)``: two shards on one card).

    ``chunk`` batches that many timepoints into each fused call (the
    movie path's chunk): a chunk's ``chunk x positions x tiles`` block runs
    as one call a shard and stitch trackers carry their state across
    chunks. ``chunk=None`` sizes it (:func:`plan_calls`). On the card a call
    holds at most :meth:`~aliby_tpu_torch.engine.compiled.CompiledStep.
    max_fields` fields, shared by the shards of one card: a plate that does
    not fit runs as rounds of positions, one round after another.

    Each run starts from the fused step's initial sticky width. ``report``,
    if given, receives the run's ``state`` (that width after the run) and
    ``shard_launches`` (each shard's kernel launches by wrapper name).
    """
    from aliby_tpu_torch.pipe import init_step

    devices = _dp_devices(mesh, device)
    output_path = Path(output_path)
    entries = []
    for pos in positions:
        pipeline = stamp_image_kwargs(base_pipeline, pos, regex=regex, capture_order=capture_order)
        validate_pipeline(pipeline)
        if (output_path / "profiles" / f"{pos['key']}.parquet").exists() and not overwrite:
            logger.info("Skipping %s", pos["key"])
            continue
        tiler = init_step("tile", pipeline["steps"]["tile"], {}, device=devices[0])
        entries.append({"pos": pos, "pipeline": pipeline, "tiler": tiler})
    timing = {k: 0.0 for k in TIMING_KEYS} if os.environ.get("ALIBY_MESH_TIMING") else None
    if not entries:
        return entries, timing
    sharded_pair = try_compile_sharded(entries[0]["pipeline"], devices)
    if sharded_pair is None:
        return None
    steps, sharded = sharded_pair
    compiled = steps[0]
    for e in entries:
        e["state"] = {"tps": {n: 0 for n in e["pipeline"]["steps"]}, "data": {},
                      "fn": {"tile": e["tiler"]}, "timer": StepTimer()}
    ntps = base_pipeline.get("ntps", 1)
    dp = len(devices)

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
        timepoints, the positions split over the dp shards; ``first`` is
        the group's first tile fetch, if made."""
        parts = [(i, list(r)) for i, r in enumerate(_split_positions(len(group), dp)) if len(r)]
        shards = [i for i, _ in parts]

        def submit_io(tp):
            # one future per position, not pool.map inside pool.submit (a
            # nested map can deadlock a bounded pool)
            return [done(first) if tp == 0 and i == 0 and first is not None
                    else pool.submit(lambda e=e: e["tiler"].run_tp(tp))
                    for i, e in enumerate(group)]

        def fetch_tp(futs):
            """Block on one tp's IO: (per-position tile results, per-position
            (F, ...) pixel blocks, F)."""
            tile_results = [f.result() for f in futs]
            blocks = []
            for tr in tile_results:
                pb = np.asarray(tr.pop("pixels"), np.float32)
                blocks.append(pb[0] if pb.ndim == 6 else pb)
            n_tiles = [pb.shape[0] for pb in blocks]
            if len(set(n_tiles)) != 1:
                raise ValueError(f"batching positions needs equal tile counts; got {n_tiles}")
            return tile_results, blocks, n_tiles[0]

        def bookkeep_chunk(ch, per_tp_tiles, outs, overrides):
            """Split one chunk's results back per (tp, position) and run the
            CompiledStep bookkeeping, each position in its own thread."""

            def ingest(item):
                j, g, P, out, ovr = item  # position g, the j-th of its shard's P
                e = group[g]
                steps_dir = output_path / "steps" / e["pos"]["key"]
                for k, tp in enumerate(ch):  # tps in order within a position
                    sl = slice(k * P * F + j * F, k * P * F + (j + 1) * F)
                    per_pos = {
                        "labels": [lab[sl] for lab in out["labels"]],
                        "features": [[(names, arr[:, sl]) for names, arr in per_obj]
                                     for per_obj in out["features"]],
                    }
                    compiled.run_tp(tp, e["tiler"], e["state"], e["pipeline"], steps_dir,
                                    tile_result=per_tp_tiles[k][g], out=per_pos,
                                    tracker_override=ovr[k][j] if ovr else None)

            list(pool.map(ingest, [(j, g, len(members), out, ovr)
                                   for (_, members), out, ovr in zip(parts, outs, overrides)
                                   for j, g in enumerate(members)]))

        scan_tracker = C > 1 and bool(compiled.tracker_specs)
        chunks = [list(range(i, min(i + C, ntps))) for i in range(0, ntps, C)]
        io_futs = {tp: submit_io(tp) for tp in chunks[0]}
        fetched = {}
        pending = None  # (chunk tps, per-tp tiles, handles, tracked) awaiting readback
        carries = [None] * len(parts)

        def readback(p_ch, p_handles, p_tracked):
            outs = sharded.collect_shards(p_handles, shards=shards)
            if p_tracked is None:
                return outs, [None] * len(parts)
            overrides = sharded.map(
                lambda i, tr, P: compiled.tracker_overrides(tr, len(p_ch), P, F),
                [(tr, len(m)) for tr, (_, m) in zip(p_tracked, parts)], shards=shards)
            return outs, overrides

        for ci, ch in enumerate(chunks):
            per_tp_tiles, per_tp_blocks = [], []
            for tp in ch:
                if tp not in fetched:
                    fetched[tp] = _timed("io_wait", fetch_tp, io_futs.pop(tp))
                tr, blks, f_tp = fetched.pop(tp)
                if f_tp != F:
                    raise ValueError(f"tile count changed across tps: {f_tp} != {F}")
                per_tp_tiles.append(tr)
                per_tp_blocks.append(blks)
            # a shard's block: its positions' tiles, (tp, position, tile)-major
            blocks = _timed("stack", lambda: [
                np.concatenate([blks[g] for blks in per_tp_blocks for g in members])
                for _, members in parts])
            # each shard copies its block to its device on its own stream and
            # reads its label count back after segmentation (the shared
            # sticky width), then queues its trees; this chunk's tracking is
            # queued behind them, and the previous chunk's readback and
            # bookkeeping run while the devices work
            handles = _timed("dispatch", sharded.dispatch, blocks, shards=shards)
            tracked = None
            if scan_tracker:
                # the previous chunk is not ingested yet: its tracker state
                # comes from its own device tensors
                def track(i, h, P, carry):
                    t = compiled.track_chunk(sharded.runs[i].device_labels(h), P, F, len(ch),
                                             carry=carry)
                    return t, compiled.chunk_carry(t, base_pipeline)

                tracked, carries = zip(*sharded.map(
                    track, [(h, len(m), c) for h, (_, m), c in zip(handles, parts, carries)],
                    shards=shards))
            if ci + 1 < len(chunks):
                for tp in chunks[ci + 1]:
                    io_futs[tp] = submit_io(tp)
            if pending is not None:
                p_ch, p_tiles, p_handles, p_tracked = pending
                outs, overrides = _timed("collect", readback, p_ch, p_handles, p_tracked)
                _timed("bookkeep", bookkeep_chunk, p_ch, p_tiles, outs, overrides)
            pending = (ch, per_tp_tiles, handles, tracked)
        p_ch, p_tiles, p_handles, p_tracked = pending
        outs, overrides = _timed("collect", readback, p_ch, p_handles, p_tracked)
        _timed("bookkeep", bookkeep_chunk, p_ch, p_tiles, outs, overrides)

    pool = ThreadPoolExecutor(max_workers=min(8, max(2, len(entries))))
    try:
        # the first position's first fetch gives the tiles a timepoint and
        # their size, which the plan of calls needs
        first = _timed("io_wait", entries[0]["tiler"].run_tp, 0)
        shape = np.shape(first["pixels"])
        F, field_pixels = shape[-5], shape[-2] * shape[-1]
        G, C = plan_calls(len(entries), F, ntps, chunk, _shard_max_fields(steps, field_pixels),
                          compiled.movie_capable(), dp)
        if G < len(entries):
            logger.info("mesh: %d positions in rounds of %d over %d shards, chunks of %d tps",
                        len(entries), G, dp, C)
        for g0 in range(0, len(entries), G):
            run_group(entries[g0:g0 + G], C, first if g0 == 0 else None)
    finally:
        pool.shutdown(wait=False)
        sharded.close()
    if report is not None:
        report.update(state=dict(sharded.state), shard_launches=sharded.shard_launches)
    return entries, timing


def run_positions_mesh(base_pipeline: dict, positions: Sequence[dict], output_path: str | Path,
                       regex: str | None = None, capture_order: str | None = None,
                       mesh: Mesh | None = None, overwrite: bool = False,
                       chunk: int | None = None, device=None) -> dict[str, tuple]:
    """Run every position through the fused step over the dp devices of
    ``mesh`` (default :func:`~aliby_tpu_torch.parallel.mesh.make_mesh`:
    every visible card; ``device=`` runs on that device alone)
    (:func:`run_positions_mesh_states`), then finalize each: profiles
    parquet, global steps. Returns {position_key: (profiles, post_results)}
    like ``run_positions``."""
    from aliby_tpu_torch.pipe import init_step

    if mesh is None and device is None:
        mesh = make_mesh()
    devices = _dp_devices(mesh, device)
    ran = run_positions_mesh_states(base_pipeline, positions, output_path, regex=regex,
                                    capture_order=capture_order, mesh=mesh, device=device,
                                    overwrite=overwrite, chunk=chunk)
    if ran is None:
        logger.warning("pipeline not fused-eligible; falling back to threaded positions")
        return run_positions(base_pipeline, positions, output_path, regex=regex,
                             capture_order=capture_order, overwrite=overwrite, devices=devices)
    entries, timing = ran
    t_fin = time.perf_counter()
    with ThreadPoolExecutor(max_workers=min(8, max(2, len(entries)))) as pool:
        finalized = list(pool.map(
            lambda e: finalize_position(e["state"], e["pipeline"], e["pos"]["key"], output_path,
                                        init_step, post_state_hook=None, device=devices[0]),
            entries))
    results = {e["pos"]["key"]: prof for e, prof in zip(entries, finalized)}
    if timing is not None:
        timing["finalize"] = time.perf_counter() - t_fin
        logger.warning("mesh timing (dispatch-thread blocking, %d tps x %d pos): %s; "
                       "accounted %.3fs", base_pipeline.get("ntps", 1), len(entries),
                       " ".join(f"{k}={v:.3f}s" for k, v in timing.items()),
                       sum(timing.values()))
    return results
