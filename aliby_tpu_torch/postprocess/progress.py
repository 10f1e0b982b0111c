"""Workload/progress estimation over pipeline outputs (a copy of
``aliby_tpu/postprocess/progress.py``, numpy only).

The reference's ``BridgeH5.get_npairs*`` (``agora/io/bridge.py:66-89``)
estimated remaining segmentation workload from the h5 cell-info tree to
drive progress bars. This is the npz/parquet-era equivalent: object counts
and pair-workload estimates straight from a position's step checkpoints,
plus a whole-run progress summary across positions.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np


def count_objects_per_tp(step_dir: str | Path) -> list[int]:
    """Objects per timepoint from per-tp npz mask checkpoints."""
    out = []
    for f in sorted(Path(step_dir).glob("*.npz")):
        with np.load(f) as npz:
            if "tile_0" in npz:
                stacks = [npz[k] for k in npz.keys() if k.startswith("tile_")]
                labels = set()
                for s in stacks:
                    labels.update(int(v) for v in np.unique(s) if v)
                out.append(len(labels))
            else:
                arr = npz["arr_0"]
                n = 0
                for tile in arr:
                    n += len([v for v in np.unique(tile) if v])
                out.append(n)
    return out


def get_npairs(step_dir: str | Path, nspecial: int = 2) -> int:
    """Tracking-workload estimate: sum over tps of C(n_objects, nspecial)
    (the reference's pair-combinatorics heuristic)."""
    return int(
        sum(
            math.comb(n, nspecial) if n >= nspecial else 0
            for n in count_objects_per_tp(step_dir)
        )
    )


def run_progress(output_path: str | Path, positions: list[str]) -> dict:
    """{position: {"done": bool, "tps_written": int}} + overall fraction."""
    output_path = Path(output_path)
    report: dict = {"positions": {}, "fraction_done": 0.0}
    done = 0
    for pos in positions:
        profiles = output_path / "profiles" / f"{pos}.parquet"
        steps_root = output_path / "steps" / pos
        tps = 0
        if steps_root.exists():
            for step_dir in steps_root.iterdir():
                tps = max(tps, len(list(step_dir.glob("*.npz"))))
        finished = profiles.exists()
        done += finished
        report["positions"][pos] = {"done": finished, "tps_written": tps}
    report["fraction_done"] = done / max(len(positions), 1)
    return report
