"""Compiled execution of standard pipelines (counterpart of
``aliby_tpu/engine/compiled.py``).

``try_compile(pipeline, ...)`` turns an eligible pipeline (a ``tile`` step,
local ``cellpose`` segment steps fed by ``passed_methods`` pixels, and
``extract*`` steps fed masks by those segmenters: what
:func:`~aliby_tpu_torch.engine.builders.build_pipeline_steps` emits) into
one fused per-timepoint step (:mod:`aliby_tpu_torch.engine.fused`), and
returns ``None`` for a pipeline that is not eligible. Unlike the reference,
which falls back to interpreting on any error, a device or kernel-build
error raises here: only an unknown metric makes a pipeline ineligible.

The per-timepoint runner (``CompiledStep.run_tp``/``run_movie``) needs the
tiler, IO and tracking, which are not ported yet (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

import logging

from aliby_tpu_torch.device import resolve_device

logger = logging.getLogger("aliby_tpu_torch")

_RUNNER_ITEM = "the tiler, IO and tracking runner (ROADMAP queue 1, item 9)"
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


def try_compile(pipeline: dict, *, device=None) -> "CompiledStep | None":
    """The fused step of ``pipeline`` on ``device`` (``cuda`` by default),
    cached per pipeline signature and device; ``None`` when ineligible.
    The reference's ``tiler`` and ``init_step_fn`` feed its runner, which
    is not ported (item 9): passing them positionally is a TypeError."""
    device = resolve_device(device)
    sig = (_pipeline_signature(pipeline), str(device))
    if sig in _COMPILED_CACHE:
        return _COMPILED_CACHE[sig]
    compiled = _try_compile_uncached(pipeline, device)
    if len(_COMPILED_CACHE) < 16:  # bounded; plates reuse one entry
        _COMPILED_CACHE[sig] = compiled
    return compiled


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
    for tr_name in track_names:
        deps = dict((kwd, src) for kwd, src, *_ in passed_data.get(tr_name, ()))
        if deps.get("masks") not in seg_names:
            return None
        raise NotImplementedError(f"tracking step {tr_name!r}: {_RUNNER_ITEM}")
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
    return CompiledStep(fused, seg_names, ext_of_seg)


class CompiledStep:
    """The fused step of one pipeline, with the names that map its outputs
    back to the pipeline's segment and extract steps."""

    def __init__(self, fused, seg_names, ext_of_seg):
        self.fused = fused
        self.seg_names = seg_names
        self.ext_of_seg = ext_of_seg

    def run_tp(self, *args, **kwargs):
        raise NotImplementedError(f"CompiledStep.run_tp: {_RUNNER_ITEM}")

    def run_movie(self, *args, **kwargs):
        raise NotImplementedError(f"CompiledStep.run_movie: {_RUNNER_ITEM}")
