"""Metadata dispatch: microscope logs -> minimal acquisition metadata (a
copy of ``aliby_tpu/logparse/metadata.py``).

Reference behavior (``agora/io/metadata.py:12-96`` + ``metadata_legacy``):
a ``*.log`` file parses through the Swain-lab grammar, legacy ``*log.txt``
/ ``*acq.txt`` pairs go through the grammar parser; ``MetaData.minimal``
keeps just channels + ntimepoints + timeinterval — what the imaging
pipeline actually consumes.
"""

from __future__ import annotations

from pathlib import Path

from aliby_tpu_torch.logparse.grammar import GrammarParser, dispatch_grammar
from aliby_tpu_torch.logparse.swainlab import parse_swainlab_logs


def parse_microscopy_logs(path: str | Path) -> dict:
    """Parse whatever microscope logs live in/next to ``path``."""
    path = Path(path)
    candidates: list[Path] = []
    if path.is_dir():
        candidates = sorted(path.glob("*.log")) + sorted(path.glob("*.txt"))
    else:
        candidates = [path]
    if not candidates:
        raise FileNotFoundError(f"No microscope logs under {path}")
    merged: dict = {}
    for f in candidates:
        if f.suffix == ".log":
            merged.update(parse_swainlab_logs(f))
        else:
            parser = GrammarParser(dispatch_grammar(f.name))
            with open(f, encoding="utf-8", errors="ignore") as fh:
                merged.update(parser.parse(fh))
    return merged


class MetaData:
    """Full metadata + the minimal view the pipeline needs."""

    def __init__(self, full: dict):
        self.full = full

    @classmethod
    def from_logs(cls, path: str | Path) -> "MetaData":
        return cls(parse_microscopy_logs(path))

    @property
    def minimal(self) -> dict:
        full = self.full
        channels = full.get("channels")
        if isinstance(channels, list) and channels and isinstance(channels[0], dict):
            channels = [row.get("channel") for row in channels]
        ntps = full.get("time_settings/ntimepoints")
        interval = full.get("time_settings/timeinterval")
        ts = full.get("time_settings")
        if isinstance(ts, list) and ts:
            ntps = ntps or ts[0].get("ntimepoints")
            interval = interval or ts[0].get("timeinterval")
        return {
            "channels": channels or [],
            "ntimepoints": ntps,
            "timeinterval": interval,
        }
