"""Compiled execution of standard pipelines (counterpart of
``aliby_tpu/engine/compiled.py``).

``try_compile(pipeline, ...)`` turns an eligible pipeline (a ``tile`` step,
local ``cellpose`` segment steps fed by ``passed_methods`` pixels,
``extract*`` steps fed masks by those segmenters, and per-tp ``track*``
steps on those masks: what
:func:`~aliby_tpu_torch.engine.builders.build_pipeline_steps` emits) into
one fused per-timepoint step (:mod:`aliby_tpu_torch.engine.fused`) driven by
a :class:`CompiledStep`, and returns ``None`` for a pipeline that is not
eligible. Unlike the reference, which falls back to interpreting on any
error, a device or kernel-build error raises here: only an unknown metric
makes a pipeline ineligible.

State layout, saves, profiles and post-processing are those of the
interpreted path; only the dispatch granularity changes.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from aliby_tpu_torch.device import resolve_device

logger = logging.getLogger("aliby_tpu_torch")

_COMPILED_CACHE: dict = {}


def _pipeline_signature(pipeline: dict) -> str:
    """Position-independent signature: everything try_compile consumes
    except the tile step's ``image_kwargs`` (the only per-position stamp),
    so the positions of one plate share one fused step."""
    steps = {
        name: {k: v for k, v in params.items() if k != "image_kwargs"}
        for name, params in pipeline["steps"].items()
    }
    return repr(
        (
            sorted((n, repr(p)) for n, p in steps.items()),
            repr(pipeline.get("passed_methods", {})),
            repr(pipeline.get("passed_data", {})),
        )
    )


def try_compile(pipeline: dict, tiler=None, init_step_fn=None, *,
                device=None) -> "CompiledStep | None":
    """The compiled step of ``pipeline`` on ``device`` (``cuda`` by
    default), cached per pipeline signature and device; ``None`` when
    ineligible. ``tiler`` and ``init_step_fn`` are the reference's
    arguments; the fused step needs neither."""
    device = resolve_device(device)
    sig = (_pipeline_signature(pipeline), str(device))
    if sig in _COMPILED_CACHE:
        return _COMPILED_CACHE[sig]
    compiled = _try_compile_uncached(pipeline, device)
    if len(_COMPILED_CACHE) < 16:  # bounded; plates reuse one entry
        _COMPILED_CACHE[sig] = compiled
    return compiled


def try_compile_sharded(pipeline: dict, devices) -> "tuple[list[CompiledStep], object] | None":
    """The compiled step of ``pipeline`` on each of ``devices`` (a device
    may repeat: its shards share one compiled step) and an
    :class:`~aliby_tpu_torch.engine.fused.ShardedStep` over their fused
    steps, with a sticky state of its own that starts at the steps'
    initial width. Returns ``(the CompiledStep of each shard, the sharded
    step)``, or ``None`` when the pipeline is not eligible."""
    from aliby_tpu_torch.engine.fused import ShardedStep

    by_device = {}
    for d in devices:
        if str(d) not in by_device:
            by_device[str(d)] = try_compile(pipeline, device=d)
    steps = [by_device[str(d)] for d in devices]
    if steps[0] is None:
        return None
    return steps, ShardedStep([s.fused for s in steps])


def _try_compile_uncached(pipeline: dict, device) -> "CompiledStep | None":
    steps = pipeline["steps"]
    seg_names = [n for n in steps if n.startswith("segment")]
    ext_names = [n for n in steps if n.startswith("extract")]
    track_names = [n for n in steps if n.startswith("track") and not n.startswith("track_global")]
    if not seg_names or not ext_names:
        return None
    covered = {"tile", *seg_names, *ext_names, *track_names}
    uncovered = [n for n in steps if n not in covered]
    if uncovered:
        logger.warning("compiled mode unavailable (steps not coverable: %s)", uncovered)
        return None
    passed_methods = pipeline.get("passed_methods", {})
    passed_data = pipeline.get("passed_data", {})
    from aliby_tpu_torch.engine.fused import FusedObject, compile_fused_step
    from aliby_tpu_torch.models.segment import dispatch_segmenter

    for seg_name in seg_names:
        kind = steps[seg_name].get("segmenter_kwargs", {}).get("kind", "cellpose")
        if kind not in ("cellpose", "cellpose_tpu"):
            return None
        if passed_methods.get(seg_name, (None,))[0] != "tile":
            return None
    ext_of_seg: dict[str, list[str]] = {n: [] for n in seg_names}
    for ext_name in ext_names:
        deps = dict((kwd, src) for kwd, src, *_ in passed_data.get(ext_name, ()))
        if deps.get("pixels") != "tile" or deps.get("masks") not in seg_names:
            return None
        ext_of_seg[deps["masks"]].append(ext_name)
    from aliby_tpu_torch.track.dispatch import dispatch_tracker

    trackers, tracker_specs = {}, {}
    for tr_name in track_names:
        deps = dict((kwd, src) for kwd, src, *_ in passed_data.get(tr_name, ()))
        src = deps.get("masks")
        if src not in seg_names:
            return None
        spec = dict(steps[tr_name])
        trackers[tr_name] = (src, dispatch_tracker(device=device, **spec))
        kw = {k: spec[k] for k in ("iou_threshold", "max_labels") if k in spec}
        tracker_specs[tr_name] = (src, spec.get("kind", "stitch"), kw)
    objects = []
    for seg_name in seg_names:
        params = steps[seg_name]
        seg_kwargs = dict(params.get("segmenter_kwargs", {}))
        seg_kwargs.pop("kind", None)
        seg = dispatch_segmenter("cellpose", channel_to_segment=params["channel_to_segment"],
                                 device=device, **seg_kwargs)
        trees = []
        for ext_name in ext_of_seg[seg_name]:
            spec = steps[ext_name]
            trees.append((spec["tree"], spec.get("kwargs", {}).get("cp_measure_kwargs")))
        objects.append(FusedObject(seg.engine, params["channel_to_segment"],
                                   seg_kwargs.get("second_channel"), trees))
    try:
        fused = compile_fused_step(objects)
    except KeyError as e:  # an unknown metric: the pipeline is not eligible
        logger.warning("compiled mode unavailable (%s)", e)
        return None
    return CompiledStep(fused, seg_names, ext_of_seg, trackers, tracker_specs, device)


# device memory a field takes in one fused call, per pixel and segmented
# object, rounded up from chip_smoke.py's peaks on an H100 80GB HBM3 at
# 700 W: 2,116 bytes at 8 fields of 256^2 (the default bank, model
# included), 1,543 for each 1080^2 field added to a call
FIELD_BYTES_PER_PIXEL = 3072


class CompiledStep:
    """Drop-in per-timepoint runner producing the interpreted path's state."""

    def __init__(self, fused, seg_names, ext_of_seg, trackers=None, tracker_specs=None,
                 device=None):
        self.fused = fused
        self.seg_names = seg_names
        self.ext_of_seg = ext_of_seg
        self.trackers = trackers or {}
        self.tracker_specs = tracker_specs or {}
        self.device = resolve_device(device)

    def max_fields(self, field_pixels: int) -> int | None:
        """The most fields of ``field_pixels`` pixels that one fused call
        should hold: nine tenths of the card's free memory (the caching
        allocator's idle blocks included) over a field's footprint
        (``FIELD_BYTES_PER_PIXEL``); ``None`` (no limit) off the card."""
        if self.device.type != "cuda":
            return None
        free, _ = torch.cuda.mem_get_info(self.device)
        free += torch.cuda.memory_reserved(self.device) - torch.cuda.memory_allocated(self.device)
        per_field = FIELD_BYTES_PER_PIXEL * field_pixels * len(self.seg_names)
        return max(1, int(0.9 * free) // per_field)

    def run_tp(self, tp: int, tiler, state: dict, pipeline: dict, steps_dir,
               tile_result: dict | None = None, out: dict | None = None,
               tracker_override: dict | None = None) -> None:
        """One timepoint. ``tile_result``/``out`` may be computed by a
        batching caller (the movie and mesh runners run many timepoints and
        positions through one fused call and split the results back)."""
        from aliby_tpu_torch.engine.core import cache_profile_table
        from aliby_tpu_torch.engine.fused import results_from_fused
        from aliby_tpu_torch.io.write import dispatch_write_fn

        if tile_result is None:
            tile_result = tiler.run_tp(tp)
        pixels = tile_result.pop("pixels", None)
        if out is None:
            out = self.fused(pixels)
        save_list = pipeline.get("save") or []
        save_interval = pipeline.get("save_interval", 1)

        def maybe_save(name, result):
            if save_list and (tp % save_interval) == 0 and name in save_list:
                dispatch_write_fn(name)(result, steps_dir=steps_dir, subpath=name, tp=tp)

        maybe_save("tile", tile_result)
        state["data"].setdefault("tile", []).append(tile_result)
        state["tps"]["tile"] = tp + 1
        for oi, seg_name in enumerate(self.seg_names):
            labels = out["labels"][oi]
            masks = [m.astype(np.uint16) for m in labels]
            maybe_save(seg_name, masks)
            state["data"].setdefault(seg_name, []).append(masks)
            state["tps"][seg_name] = tp + 1
            for ti, ext_name in enumerate(self.ext_of_seg[seg_name]):
                res = results_from_fused(self.fused.plans[oi][ti], *out["features"][oi][ti],
                                         labels)
                state["data"].setdefault(ext_name, []).append(res)
                state["tps"][ext_name] = tp + 1
                # format this tp's profile columns now, while the device works
                cache_profile_table(state, pipeline, ext_name)
        for tr_name, (src, tracker) in self.trackers.items():
            if tracker_override is not None and tr_name in tracker_override:
                result = tracker_override[tr_name]
            else:
                recent = state["data"].get(src, [])[-2:]
                tile_major = [[tp_tiles[t] for tp_tiles in recent] for t in range(len(recent[-1]))]
                prev = state["data"].get(tr_name, [])
                result = tracker(tile_major, state=prev[-1] if prev else None)
            maybe_save(tr_name, result)
            state["data"].setdefault(tr_name, []).append(result)
            state["tps"][tr_name] = tp + 1
        # retain trimming (the interpreted loop's semantics)
        for step_name, history in state["data"].items():
            keep = pipeline.get("retain", {}).get(step_name, "all")
            if isinstance(keep, int) and keep >= 0 and len(history) > keep:
                del history[: len(history) - keep]

    def movie_capable(self) -> bool:
        """Movie batching needs every tracker to be the stitch kind (the
        only one with a whole-movie form)."""
        return all(kind == "stitch" for _, kind, _ in self.tracker_specs.values())

    def track_chunk(self, labels, P: int, F: int, tc: int, carry: dict | None = None) -> dict:
        """Stitch-track one chunk of ``tc`` timepoints of ``P`` positions on
        the device: one :func:`~aliby_tpu_torch.track.trackers.stitch_movie`
        per tracker over all positions' tiles, starting from
        ``carry[tracker]`` (:meth:`chunk_carry` of the chunk before) or,
        without it, afresh.

        ``labels``: per object, a (rows, Y, X) int32 device tensor whose
        first ``tc * P * F`` rows are (tp, position, tile)-major.
        Returns ``{tracker: (globals (tc, P, F, Y, X), max (tc, P, F))}``,
        device tensors; nothing here waits on the device."""
        from aliby_tpu_torch.track.trackers import stitch_movie

        tracked = {}
        for tr_name, (src, _kind, kw) in self.tracker_specs.items():
            lab = labels[self.seg_names.index(src)]
            YX = tuple(lab.shape[1:])
            lab = lab[: tc * P * F].reshape((tc, P * F) + YX)
            if carry and tr_name in carry:
                g, m = stitch_movie(lab, *carry[tr_name], True, **kw)
            else:
                init_lab = torch.zeros((P * F,) + YX, dtype=torch.int32, device=lab.device)
                init_max = torch.zeros(P * F, dtype=torch.int32, device=lab.device)
                g, m = stitch_movie(lab, init_lab, init_max, False, **kw)
            tracked[tr_name] = (g.reshape((tc, P, F) + YX), m.reshape(tc, P, F))
        return tracked

    @staticmethod
    def chunk_carry(tracked: dict, pipeline: dict) -> dict:
        """The tracker state after a chunk of :meth:`track_chunk`, as its
        ``carry`` for the next chunk: the last timepoint's device tensors,
        for every tracker whose history ``retain`` keeps (with ``retain`` 0
        the next chunk starts afresh, as the per-tp path does)."""
        keep = pipeline.get("retain", {})
        return {tr: (g[-1].flatten(0, 1), m[-1].flatten(0, 1))
                for tr, (g, m) in tracked.items() if keep.get(tr, "all") != 0}

    @staticmethod
    def tracker_overrides(tracked: dict, tc: int, P: int, F: int) -> list:
        """Read :meth:`track_chunk`'s tensors back as per-(tp, position)
        tracker results ``{"labels": [...], "max_label": [...]}``."""
        overrides = [[{} for _ in range(P)] for _ in range(tc)]
        for tr_name, (g, m) in tracked.items():
            g, m = g.cpu().numpy(), m.cpu().numpy()
            for k in range(tc):
                for i in range(P):
                    overrides[k][i][tr_name] = {"labels": [g[k, i, f] for f in range(F)],
                                                "max_label": [int(m[k, i, f]) for f in range(F)]}
        return overrides

    def run_movie(self, tps, tiler, state: dict, pipeline: dict, steps_dir, monitor=None,
                  chunk: int | None = None, chunk_budget_bytes: int = 512 << 20) -> bool:
        """Run many timepoints (of a fresh ``state``) through chunked
        whole-movie dispatches: the tiles of a chunk's timepoints go through
        one fused call, and stitch tracking runs as one :meth:`track_chunk`
        a chunk, carrying ``{labels, max_label}`` across chunks on the
        device. Host IO stays sequential; state, saves, retain and profiles
        are those of the per-tp path. ``chunk=None`` sizes the chunk from
        the first tile fetch to ``chunk_budget_bytes`` of pixels; either way
        a chunk holds at most :meth:`max_fields` fields. A short last chunk
        runs at its own size (the fused step's results do not depend on the
        batch, so nothing is padded).

        Returns True if the early-stop monitor fired.
        """
        from aliby_tpu_torch.engine.core import _segment_results

        def fetch(tp):
            tile_result = tiler.run_tp(tp)
            px = np.asarray(tile_result.pop("pixels"), np.float32)
            return tp, tile_result, (px[0] if px.ndim == 6 else px)

        tps = list(tps)
        if not tps:
            return False
        first = fetch(tps[0])
        F, field_pixels = first[2].shape[0], first[2].shape[-2] * first[2].shape[-1]
        if chunk is None:
            chunk = max(1, min(16, chunk_budget_bytes // first[2].nbytes, len(tps)))
        max_fields = self.max_fields(field_pixels)
        if max_fields is not None:
            chunk = max(1, min(chunk, max_fields // F))
        carry = None
        for start in range(0, len(tps), chunk):
            pending = [first] if start == 0 else []
            pending += [fetch(tp) for tp in tps[start + len(pending):start + chunk]]
            tc = len(pending)
            stacked = np.stack([px for _, _, px in pending])  # (tc, F, C, Z, Y, X)
            handle = self.fused.dispatch(stacked.reshape((tc * F,) + stacked.shape[2:]))
            tracked = self.track_chunk(self.fused.device_labels(handle), 1, F, tc, carry=carry)
            carry = self.chunk_carry(tracked, pipeline)
            out = self.fused.collect(handle)
            overrides = self.tracker_overrides(tracked, tc, 1, F)
            for k, (tp, tile_result, _px) in enumerate(pending):
                out_k = {
                    "labels": [lab[k * F:(k + 1) * F] for lab in out["labels"]],
                    "features": [[(names, arr[:, k * F:(k + 1) * F]) for names, arr in per_obj]
                                 for per_obj in out["features"]],
                }
                self.run_tp(tp, tiler, state, pipeline, steps_dir, tile_result=tile_result,
                            out=out_k, tracker_override=overrides[k][0])
                if (monitor is not None and monitor.enabled
                        and monitor.should_stop(tp, _segment_results(state))):
                    return True
        return False
