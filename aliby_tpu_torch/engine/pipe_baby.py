"""BABY (yeast time-lapse) pipeline flavour (counterpart of
``aliby_tpu/engine/pipe_baby.py``).

Differences from the standard flavour (reference ``pipe_baby.py:30-136``):
segment steps run the in-process BABY-class segmenter
(:mod:`aliby_tpu_torch.models.baby`), whose results carry layered masks and
tracking metadata; extraction runs the overlap path; ``extractmulti_*`` is
rejected; after profiles are written, the post-state hook folds the per-tp
metadata into ``tracking/<pos>_<step>.parquet``. Device steps run on
``device`` (``cuda`` unless the caller passes ``device="cpu"``);
:func:`tracking_columns` gives the tracking tables of a state without
pyarrow.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

from aliby_tpu_torch.engine.baby_parser import baby_tracking_columns, baby_tracking_to_table
from aliby_tpu_torch.engine.core import (
    _init_embed,
    _init_extract,
    _init_nahual_embed,
    _init_nahual_track,
    _init_tile,
    _run_pipeline_and_post_impl,
)


def _init_segment_baby(step_name: str, parameters: dict, other_steps: dict,
                       device=None) -> Callable:
    from aliby_tpu_torch.models.segment import dispatch_segmenter

    seg_kwargs = dict(parameters.get("segmenter_kwargs", {}))
    kind = seg_kwargs.pop("kind", "baby")
    if kind == "baby":
        # BABY can pull pixels through the tiler built earlier in this tp;
        # the live path feeds them positionally (passed_methods)
        tiler = other_steps.get("tile")
        if tiler is not None:
            seg_kwargs.setdefault("tiler", tiler)
    return dispatch_segmenter(kind=kind, channel_to_segment=parameters.get("channel_to_segment", 0),
                              device=device, **seg_kwargs)


def init_step(step_name: str, parameters: dict, other_steps: dict | None = None,
              device=None) -> Callable:
    if other_steps is None:
        other_steps = {}
    if step_name.startswith("tile"):
        return _init_tile(step_name, parameters, device=device)
    if step_name.startswith("segment"):
        return _init_segment_baby(step_name, parameters, other_steps, device=device)
    if step_name.startswith("extractmulti_"):
        raise ValueError("extractmulti_* steps are not supported in the BABY flavour")
    if step_name.startswith("extract"):
        return _init_extract(step_name, parameters, overlap=True, device=device)
    if step_name.startswith("nahual_embed"):
        return _init_nahual_embed(step_name, parameters, device=device)
    if step_name.startswith("nahual_track"):
        return _init_nahual_track(step_name, parameters, device=device)
    if step_name.startswith("embed"):
        return _init_embed(step_name, parameters, device=device)
    raise ValueError(f"No initializer for step {step_name!r}")


def _per_tp_metadata(state: dict, step_name: str) -> list:
    # the full per-tp metadata is kept at step time (engine/core.py), so
    # retain-trimming of the segment history cannot truncate the lineage
    return state.get("meta_history", {}).get(step_name) or [
        r.get("metadata") if isinstance(r, dict) else None
        for r in state["data"].get(step_name, [])
    ]


def tracking_columns(state: dict, pipeline: dict) -> dict:
    """{segment step: its tracking table as numpy columns} of a finished
    state (steps without BABY metadata left out)."""
    out = {}
    for step_name in pipeline["steps"]:
        if step_name.startswith("segment"):
            meta = _per_tp_metadata(state, step_name)
            if any(meta):
                out[step_name] = baby_tracking_columns(meta)
    return out


def _save_baby_tracking_lineage(state, pipeline, pipeline_name, output_path) -> None:
    """Write ``tracking/<pipeline_name>_<step>.parquet`` per segment step
    (the post-state hook of :func:`run_pipeline_and_post`)."""
    import pyarrow.parquet as pq

    out_dir = Path(output_path) / "tracking"
    for step_name in pipeline["steps"]:
        if not step_name.startswith("segment"):
            continue
        meta = _per_tp_metadata(state, step_name)
        if not any(meta):
            continue
        out_dir.mkdir(parents=True, exist_ok=True)
        pq.write_table(baby_tracking_to_table(meta),
                       out_dir / f"{pipeline_name}_{step_name}.parquet", compression="zstd")


def run_pipeline_and_post(pipeline: dict, pipeline_name: str, output_path,
                          overwrite: bool = False, device=None):
    """Run one position, write its profiles parquet, saves and tracking
    parquet (the reference's ``pipe_baby.run_pipeline_and_post``, with
    ``device``)."""
    return _run_pipeline_and_post_impl(pipeline, pipeline_name, output_path, init_step,
                                       post_state_hook=_save_baby_tracking_lineage,
                                       overwrite=overwrite, device=device)
