"""Multi-position execution in threads (counterpart of
``aliby_tpu/parallel/positions.py``).

Positions run as threads in one process sharing the loaded models and
built kernels; position ``i`` runs on ``devices[i % len(devices)]``
(round-robin over every visible CUDA device by default: the reference's
``jax.default_device`` pinning). IO (TIFF/zarr decode) overlaps across
threads while each device's queue serialises compute.
"""

from __future__ import annotations

import logging
import threading
from concurrent.futures import ThreadPoolExecutor, as_completed
from copy import deepcopy
from pathlib import Path
from typing import Callable, Sequence

import torch

from aliby_tpu_torch.device import resolve_device

logger = logging.getLogger("aliby_tpu_torch")


def stamp_image_kwargs(pipeline: dict, position: dict, regex: str | None = None,
                       capture_order: str | None = None) -> dict:
    """Deep-copy ``pipeline`` and stamp the position's image source into its
    tile step (callers rely on the base pipeline staying untouched)."""
    stamped = deepcopy(pipeline)
    image_kwargs: dict = {"source": {"key": position["key"], "path": position["path"]}}
    if regex is not None:
        image_kwargs["regex"] = regex
    if capture_order is not None:
        image_kwargs["capture_order"] = capture_order
    stamped["steps"]["tile"]["image_kwargs"] = image_kwargs
    stamped["io"] = {
        "input_path": {"key": position["key"], "path": position["path"]},
        "capture_order": capture_order,
    }
    return stamped


def visible_devices() -> list[torch.device]:
    """Every visible CUDA device; raises (through ``resolve_device``) when
    there is none."""
    n = torch.cuda.device_count()
    return [torch.device("cuda", i) for i in range(n)] if n else [resolve_device(None)]


def run_positions(base_pipeline: dict, positions: Sequence[dict], output_path: str | Path,
                  regex: str | None = None, capture_order: str | None = None,
                  n_workers: int = 4, overwrite: bool = False, flavor: str = "standard",
                  run_fn: Callable | None = None, devices: Sequence | None = None
                  ) -> dict[str, tuple]:
    """Run every position; returns {position_key: (profiles, post)}.
    ``run_fn`` is called with the reference's keywords and ``device``."""
    if run_fn is None:
        if flavor == "baby":
            from aliby_tpu_torch.pipe_baby import run_pipeline_and_post as run_fn
        else:
            from aliby_tpu_torch.pipe import run_pipeline_and_post as run_fn
    devices = [resolve_device(d) for d in devices] if devices is not None else visible_devices()
    output_path = Path(output_path)
    results: dict[str, tuple] = {}
    lock = threading.Lock()

    def one(i: int, position: dict):
        pipeline = stamp_image_kwargs(base_pipeline, position, regex=regex,
                                      capture_order=capture_order)
        out = run_fn(pipeline=pipeline, pipeline_name=position["key"], output_path=output_path,
                     overwrite=overwrite, device=devices[i % len(devices)])
        with lock:
            results[position["key"]] = out
        return position["key"]

    if n_workers <= 1:
        for i, pos in enumerate(positions):
            one(i, pos)
        return results

    with ThreadPoolExecutor(max_workers=n_workers) as pool:
        futures = {pool.submit(one, i, pos): pos["key"] for i, pos in enumerate(positions)}
        for fut in as_completed(futures):
            key = futures[fut]
            try:
                fut.result()
                logger.info("Position %s done", key)
            except Exception:
                logger.exception("Position %s failed", key)
                raise
    return results
