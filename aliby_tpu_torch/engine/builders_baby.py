"""BABY pipeline-definition builder (counterpart of
``aliby_tpu/engine/builders_baby.py``; reference
``pipe_builder_baby.py:16-108``).

Hard-wired to the BABY segmenter family: the in-process equivalent, or
the remote ``nahual_baby`` kind when ``baby_address`` is given (the remote
clients are not ported: ROADMAP queue 1, item 8). No extractmulti steps;
extraction runs the overlap path; segmenters receive pixels through
``passed_methods``.
"""

from __future__ import annotations

from typing import Sequence

DEFAULT_BABY_FEATURES = ("intensity", "sizeshape")


def build_pipeline_steps(channels_to_segment: dict[str, int] | None = None,
                         channels_to_extract: Sequence[int] | None = None,
                         features_to_extract: Sequence[str] = DEFAULT_BABY_FEATURES,
                         extract_ncores: int | None = None, baby_address: str | None = None,
                         baby_modelset: str | None = None,
                         steps_to_write: Sequence[str] | None = None,
                         cp_measure_feature_kwargs: dict | None = None,
                         tile_size: int | None = 117, **segmenter_extra) -> dict:
    if channels_to_segment is None:
        channels_to_segment = {"cell": 0}
    if channels_to_extract is None:
        channels_to_extract = list(channels_to_segment.values())
    if baby_address is not None:
        seg_kwargs = dict(kind="nahual_baby", address=baby_address,
                          setup_params={"modelset": baby_modelset})
    else:
        seg_kwargs = dict(kind="baby", **segmenter_extra)
    seg_steps = {
        f"segment_{obj}": dict(segmenter_kwargs=dict(seg_kwargs), channel_to_segment=channel)
        for obj, channel in channels_to_segment.items()
    }
    extract_kwargs: dict = dict(ncores=extract_ncores)
    if cp_measure_feature_kwargs:
        extract_kwargs["cp_measure_kwargs"] = dict(cp_measure_feature_kwargs)
    tree: dict = {"None": {"None": ("sizeshape",)}}
    for channel in channels_to_extract:
        tree[channel] = {"max": features_to_extract}
    extract_steps = {
        f"extract_{obj}": {"tree": dict(tree), "kwargs": dict(extract_kwargs)}
        for obj in channels_to_segment
    }
    pipeline = {
        "steps": dict(tile=dict(tile_size=tile_size), **seg_steps, **extract_steps),
        "passed_data": {
            f"extract_{obj}": [("masks", f"segment_{obj}"), ("pixels", "tile")]
            for obj in channels_to_segment
        },
        "passed_methods": {f"segment_{obj}": ("tile", "get_fczyx") for obj in channels_to_segment},
        "save": [f"segment_{obj}" for obj in channels_to_segment],
        "save_interval": 1,
    }
    if steps_to_write is not None:
        pipeline["save"] = list(steps_to_write)
    return pipeline
