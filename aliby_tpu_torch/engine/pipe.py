"""Standard (cellpose + feature-bank) pipeline flavour (counterpart of
``aliby_tpu/engine/pipe.py``).

Step-name-prefix dispatch (reference ``pipe.py:47-77``): ``tile*`` ->
tiler, ``segment*`` -> segmenter, ``track_global`` -> the in-process
whole-movie linker, ``track*`` -> tracker, ``extractmulti_*`` ->
multi-channel tree, ``extract_*`` -> single-channel tree, ``embed*`` ->
the in-process embedder, ``nahual_embed*`` / ``nahual_track*`` -> clients
of a model server. Device steps run on ``device`` (``cuda`` unless the
caller passes ``device="cpu"``).
"""

from __future__ import annotations

from typing import Callable

from aliby_tpu_torch.engine.core import (
    _init_embed,
    _init_extract,
    _init_extract_multi,
    _init_nahual_embed,
    _init_nahual_track,
    _init_tile,
    _run_pipeline_and_post_impl,
)


def _init_segment(step_name: str, parameters: dict, other_steps: dict, device=None) -> Callable:
    from aliby_tpu_torch.models.segment import dispatch_segmenter

    if "channel_to_segment" not in parameters:
        raise ValueError(f"Step '{step_name}' is missing required 'channel_to_segment'.")
    seg_kwargs = dict(parameters.get("segmenter_kwargs", {}))
    kind = seg_kwargs.pop("kind", "cellpose")
    return dispatch_segmenter(kind=kind, channel_to_segment=parameters["channel_to_segment"],
                              device=device, **seg_kwargs)


def _init_track(step_name: str, parameters: dict, other_steps: dict, device=None) -> Callable:
    from aliby_tpu_torch.track.dispatch import dispatch_tracker

    return dispatch_tracker(device=device, **parameters)


def _init_track_global(step_name: str, parameters: dict, device=None) -> Callable:
    from aliby_tpu_torch.engine.global_steps import dispatch_global_step

    return dispatch_global_step("track_global", device=device, **parameters)


def init_step(step_name: str, parameters: dict, other_steps: dict | None = None,
              device=None) -> Callable:
    if other_steps is None:
        other_steps = {}
    if step_name.startswith("tile"):
        return _init_tile(step_name, parameters, device=device)
    if step_name.startswith("segment"):
        return _init_segment(step_name, parameters, other_steps, device=device)
    if step_name.startswith("track_global"):
        return _init_track_global(step_name, parameters, device=device)
    if step_name.startswith("track"):
        return _init_track(step_name, parameters, other_steps, device=device)
    if step_name.startswith("extractmulti_"):
        return _init_extract_multi(step_name, parameters, device=device)
    if step_name.startswith("extract"):
        return _init_extract(step_name, parameters, device=device)
    if step_name.startswith("nahual_embed"):
        return _init_nahual_embed(step_name, parameters, device=device)
    if step_name.startswith("nahual_track"):
        return _init_nahual_track(step_name, parameters, device=device)
    if step_name.startswith("embed"):
        return _init_embed(step_name, parameters, device=device)
    raise ValueError(f"No initializer for step {step_name!r}")


def run_pipeline_and_post(pipeline: dict, pipeline_name: str, output_path,
                          overwrite: bool = False, device=None):
    """Run one position and write its profiles parquet, saves and global
    steps (the reference's ``run_pipeline_and_post``, with ``device``)."""
    return _run_pipeline_and_post_impl(pipeline, pipeline_name, output_path, init_step,
                                       post_state_hook=None, overwrite=overwrite,
                                       device=device)
