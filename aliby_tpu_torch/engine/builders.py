"""Standard pipeline-definition builder (counterpart of
``aliby_tpu/engine/builders.py``).

Produces the pipeline dict: per-object ``segment_<obj>`` steps (local
``cellpose``, or ``nahual_cellpose`` when ``nahual_addresses`` is given),
one ``extract_<obj>`` per object (sizeshape + per-channel feature tree), one
``extractmulti_<obj>`` with per-channel-pair colocalisation, ``passed_data``
wiring masks <- segment and pixels <- tile, ``passed_methods`` feeding the
segmenters through ``("tile", "get_fczyx")``, and the default ``save`` of
the segment steps. ``trackastra_parameters`` alone attaches the in-process
whole-movie linker as the ``track_global`` global step;
``trackastra_address`` a model server's linker as ``nahual_trackastra``.
"""

from __future__ import annotations

from itertools import combinations, product
from typing import Sequence

from aliby_tpu_torch.engine.core import _attach_trackastra

DEFAULT_FEATURES = (
    "radial_zernikes",
    "intensity",
    "feret",
    "texture",
    "radial_distribution",
    "zernike",
)


def _coloc_tree(channels: Sequence[int], extract_ncores,
                cp_measure_feature_kwargs: dict | None = None) -> dict:
    kwargs: dict = {"ncores": extract_ncores}
    if cp_measure_feature_kwargs:
        kwargs["cp_measure_kwargs"] = dict(cp_measure_feature_kwargs)
    return {
        "tree": {
            pair: {"None": {"max": ["pearson", "costes", "manders_fold", "rwc"]}}
            for pair in combinations(channels, r=2)
        },
        "kwargs": kwargs,
    }


def build_pipeline_steps(
    channels_to_segment: dict[str, int] | None = None,
    channels_to_extract: Sequence[int] | None = None,
    features_to_extract: Sequence[str] = DEFAULT_FEATURES,
    extract_ncores: int | None = None,
    nahual_addresses: str | Sequence[str] | None = None,
    steps_to_write: Sequence[str] | None = None,
    trackastra_address: str | None = None,
    trackastra_parameters: dict | None = None,
    cp_measure_feature_kwargs: dict | None = None,
    segmenter_extra_kwargs: dict | None = None,
) -> dict:
    """Build the standard pipeline definition (no IO stamped yet)."""
    if channels_to_segment is None:
        channels_to_segment = {"nuclei": 1, "cell": 0}
    if channels_to_extract is None:
        channels_to_extract = list(channels_to_segment.values())

    segmenter_kind = "nahual_cellpose" if nahual_addresses is not None else "cellpose"

    seg_steps = {}
    for obj, channel in channels_to_segment.items():
        seg_kwargs = dict(kind=segmenter_kind)
        seg_kwargs.update(segmenter_extra_kwargs or {})
        seg_steps[f"segment_{obj}"] = dict(
            segmenter_kwargs=seg_kwargs,
            channel_to_segment=channel,
        )

    extract_kwargs: dict = dict(ncores=extract_ncores)
    if cp_measure_feature_kwargs:
        extract_kwargs["cp_measure_kwargs"] = dict(cp_measure_feature_kwargs)
    mono = {
        "tree": {"None": {"None": ("sizeshape",)}},
        "kwargs": extract_kwargs,
    }
    for channel in channels_to_extract:
        mono["tree"][channel] = {"max": features_to_extract}
    multi = _coloc_tree(channels_to_extract, extract_ncores, cp_measure_feature_kwargs)

    variants = [("", mono), ("multi", multi)]
    extract_steps = {
        f"extract{name}_{obj}": spec
        for (name, spec), obj in product(variants, channels_to_segment)
        if spec
    }

    pipeline = {
        "steps": dict(
            tile=dict(tile_size=None),
            **seg_steps,
            **extract_steps,
        ),
        "passed_data": {
            f"extract{variant}_{obj}": [
                ("masks", f"segment_{obj}"),
                ("pixels", "tile"),
            ]
            for obj in channels_to_segment
            for variant in (name for name, _ in variants)
        },
        "passed_methods": {
            f"segment_{obj}": ("tile", "get_fczyx") for obj in channels_to_segment
        },
        "save": [f"segment_{obj}" for obj in channels_to_segment],
        "save_interval": 1,
    }
    if steps_to_write is not None:
        pipeline["save"] = list(steps_to_write)
    if trackastra_address is not None or trackastra_parameters is not None:
        _attach_trackastra(pipeline, channels_to_segment, trackastra_address,
                           trackastra_parameters)
    return pipeline
