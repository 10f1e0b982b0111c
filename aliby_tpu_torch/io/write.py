"""Step-output writers: per-tp ``.npz`` checkpoints and zstd Parquet
(counterpart of ``aliby_tpu/io/write.py``; pyarrow is imported inside
:func:`write_parquet` only).

On-disk layouts match the reference exactly (``aliby/io/write.py:8-74``):

- ``segment*``/``tile*`` steps -> ``steps/<pos>/<step>/<tp:04d>.npz``:
  dict results (BABY-class segmenters) are saved as ``tile_<i>`` keys with a
  ``<tp:04d>_meta.json`` sidecar holding tracking metadata; plain list/array
  results as a single stacked ``arr_0``.
- table-producing steps -> zstd Parquet.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np


def dispatch_write_fn(step_name: str):
    """Reference: ``io/write.py:8-22`` (segment/tile -> npz, trackastra ->
    parquet, anything else unsupported). Here per-tp ``track`` results
    ({"labels": [...], "max_label": [...]}) also save as npz — the
    reference raises "not supported yet" for them."""
    if step_name.startswith(("segment", "tile", "track")):
        return write_ndarray
    return write_parquet


def write_ndarray(result, steps_dir=None, subpath: str = "", tp: int = 0, **kwargs) -> Path:
    out_dir = Path(steps_dir) / subpath
    out_dir.mkdir(parents=True, exist_ok=True)
    target = out_dir / f"{tp:04d}.npz"
    if isinstance(result, dict) and "masks" in result:
        # Segmenters returning {"masks": [...], "metadata": {...}}
        masks = result["masks"]
        np.savez_compressed(
            target, **{f"tile_{i}": np.asarray(m) for i, m in enumerate(masks)}
        )
        meta = result.get("metadata")
        if meta is not None:
            (out_dir / f"{tp:04d}_meta.json").write_text(
                json.dumps(meta, default=_json_fallback)
            )
    elif isinstance(result, dict):
        # tile step result: save the drift/locations record, skip raw pixels
        payload = {
            k: np.asarray(v)
            for k, v in result.items()
            if k != "pixels" and _is_arrayish(v)
        }
        np.savez_compressed(target, **payload)
    else:
        stacked = np.stack([np.asarray(m) for m in result]) if isinstance(
            result, (list, tuple)
        ) else np.asarray(result)
        np.savez_compressed(target, stacked)
    return target


def write_parquet(result, output_path=None, subpath: str = "", filename: str = "",
                  **kwargs) -> Path:
    import pyarrow as pa
    import pyarrow.parquet as pq

    out_dir = Path(output_path) / subpath
    out_dir.mkdir(parents=True, exist_ok=True)
    target = out_dir / f"{filename}.parquet"
    if isinstance(result, pa.Table):
        table = result
    elif isinstance(result, dict):
        table = pa.Table.from_pydict(result)
    else:
        table = pa.Table.from_pandas(result)
    # stats/dict off: wide-and-short tables pay per-column-chunk overhead
    # for metadata nothing reads (see engine/core.finalize_position)
    pq.write_table(
        table, target, compression="zstd",
        write_statistics=False, use_dictionary=False,
    )
    return target


def _is_arrayish(v) -> bool:
    try:
        np.asarray(v, dtype=float)
        return True
    except Exception:
        return False


def _json_fallback(obj):
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.integer, np.floating)):
        return obj.item()
    raise TypeError(f"not JSON serializable: {type(obj)}")
