"""Dataset discovery: positions out of TIFF trees or zarr stores
(counterpart of ``aliby_tpu/io/dataset.py``).

Reference semantics (``aliby/io/dataset.py:22-231``):

- ``dispatch_dataset``: a path whose root-level children are zarr nodes ->
  ``DatasetZarr`` (each child dir = one position); otherwise ``DatasetDir``
  (regex over a recursive file scan).
- ``DatasetDir.get_position_ids``: regex-capture every file; capture_order
  chars not in ``TCZYX`` are *grouper* keys (well, field) and chars in
  ``TCZYX`` are *dim* keys; stable-sort by reversed dim keys then groupers
  (string comparison — the reference sorts raw captures), group by the
  grouper values, emit ``[{"key": "W__F", "path": [abs files in dim order]}]``.
"""

from __future__ import annotations

import os
import re
from itertools import groupby
from pathlib import Path

from aliby_tpu_torch.io import zarrlite

DIM_CHARS = "TCZYX"


def dispatch_dataset(path: str | Path, **kwargs):
    """Pick DatasetZarr when root children are zarr nodes, else DatasetDir."""
    p = Path(path)
    if p.suffix == ".zarr" or zarrlite.is_zarr_node(p):
        return DatasetZarr(p, **kwargs)
    children = [c for c in p.iterdir() if c.is_dir()]
    if children and all(zarrlite.is_zarr_node(c) or c.suffix == ".zarr" for c in children):
        return DatasetZarr(p, **kwargs)
    return DatasetDir(p, **kwargs)


def scan_directory(path: str | Path) -> list[str]:
    """Recursive file listing as ``root/file`` strings."""
    found = []
    for root, _dirs, files in os.walk(str(path)):
        for fname in files:
            entry = f"{root}/{fname}"
            if not entry.startswith("."):
                found.append(entry)
    return found


def multisort(items: list, key_indices: list[int]) -> list:
    """Sequential stable sorts; the *last* index becomes the primary key."""
    for k in key_indices:
        items.sort(key=lambda row: row[k])
    return items


def sort_groups_by_regex(
    datasets_path: str | Path,
    regex: str,
    capture_order: str,
    out_dimorder: str = DIM_CHARS,
) -> list[dict]:
    """Group files into positions by their non-TCZYX capture groups."""
    pattern = re.compile(regex)
    rows = []
    for path_str in scan_directory(datasets_path):
        m = pattern.match(path_str)
        if m:
            rows.append((*m.groups(), path_str))

    grouper_keys = [
        capture_order.index(c) for c in capture_order if c not in out_dimorder
    ]
    dim_keys = [
        capture_order.index(c)
        for c in [d for d in out_dimorder if d in capture_order]
    ]

    # Stability makes the final ordering: groupers primary, first dim key
    # (T before C before Z) the slowest-varying dim within each group.
    multisort(rows, [*dim_keys[::-1], *grouper_keys])

    position_ids = []
    for key, group in groupby(rows, key=lambda r: [r[i] for i in grouper_keys]):
        files = [r[-1] for r in group]
        if not isinstance(key, str):
            key = "__".join(key)
        position_ids.append(
            {
                "key": key,
                "path": [str(Path(datasets_path) / f) for f in files],
            }
        )
    if not position_ids:
        raise AssertionError("No files were found.")
    return position_ids


class DatasetDir:
    """A directory tree of image files carved into positions by a regex."""

    def __init__(self, path: str | Path, regex: str, capture_order: str, **kwargs):
        self.path = Path(path)
        self.regex = regex
        self.capture_order = capture_order

    def get_position_ids(self) -> list[dict]:
        groups = sort_groups_by_regex(self.path, self.regex, self.capture_order)
        # Paths are already absolute-ish (rooted at datasets_path); normalize.
        for g in groups:
            g["path"] = [str(Path(p)) for p in g["path"]]
        return groups

    @property
    def name(self) -> str:
        return self.path.stem

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class DatasetZarr:
    """A store whose root-level directories are one zarr position each."""

    def __init__(self, path: str | Path, **kwargs):
        self.path = Path(path)

    def get_position_ids(self) -> list[dict]:
        positions = []
        root = self.path
        if zarrlite.is_zarr_node(root) and not (root / ".zgroup").exists():
            # The path itself is a single array/store position.
            return [{"key": root.stem, "path": str(root)}]
        for child in sorted(root.iterdir()):
            if child.is_dir() and (
                zarrlite.is_zarr_node(child) or child.suffix == ".zarr"
            ):
                positions.append({"key": child.stem, "path": str(child)})
        if not positions:
            raise AssertionError(f"No zarr positions found under {root}")
        return positions

    @property
    def name(self) -> str:
        return self.path.stem

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
