"""Swain-lab ``.log`` microscope-file parser (a copy of
``aliby_tpu/logparse/swainlab.py``; the channel list from the port's
``utils/settings.py``).

Format (as established by the reference implementation's behavior,
``logfile_parser/swainlab_parser.py:12-133``): a header of ``key: value``
general settings, an ``-----Acquisition settings-----`` block of
comma-separated channel rows (name, mode, ?, exposure, z-sections,
z-spacing, sectioning method), a ``Device properties:`` block, a position
table headed ``Name,X,Y,Z,Autofocus offset``, free-floating
``interval: N`` / ``frames: N`` time settings, terminated by
``-----Experiment started-----``.

Output: channels list, per-channel dicts (exposure / number_z_sections /
z_spacing / sectioning_method), per-position ``spatial_locations``,
``time_settings/*`` keys, plus the raw general keys.
"""

from __future__ import annotations

import re
from pathlib import Path

from aliby_tpu_torch.utils.settings import possible_imaging_channels

IMAGING_CHANNELS = list(possible_imaging_channels) + ["Brightfield"]

_ACQ_HEADER = "-----Acquisition settings-----"
_DEVICE_HEADER = "Device properties:"
_GROUP_HEADER = "Name,X,Y,Z,Autofocus offset"
_START_MARKER = "-----Experiment started-----"


def parse_swainlab_logs(filepath: str | Path) -> dict:
    raw = _scan(filepath)
    meta = dict(raw)
    for key in ("exposure", "number_z_sections", "z_spacing", "sectioning_method"):
        meta[key] = dict(zip(raw["channels"], raw[key]))
    meta["spatial_locations"] = dict(zip(raw["group"], raw["spatial_locations"]))
    return meta


def _scan(filepath: str | Path) -> dict:
    meta: dict = {
        "channels": [],
        "exposure": [],
        "number_z_sections": [],
        "z_spacing": [],
        "sectioning_method": [],
        "group": [],
        "spatial_locations": [],
        "device": [],
    }
    section = "general"
    with open(filepath, encoding="utf-8", errors="ignore") as fh:
        for line in fh:
            line = line.rstrip()
            if line == _START_MARKER:
                break
            if line == _ACQ_HEADER:
                section = "acquisition"
                continue
            if line == _DEVICE_HEADER:
                section = "devices"
                continue
            if line == _GROUP_HEADER:
                section = "groups"
                continue
            if section == "groups" and not line:
                section = "after_groups"
                continue
            _grab_time_setting(line, meta)
            cells = [c.strip() for c in line.split(",")]
            if section == "general" and ":" in line:
                key, _, value = line.partition(":")
                if re.search("[a-zA-Z]", key):
                    meta[key.strip().lower().replace(" ", "_")] = [value.strip()]
            elif section == "acquisition":
                if (
                    len(cells) >= 7
                    and cells[0] in IMAGING_CHANNELS
                    and cells[1] in IMAGING_CHANNELS
                ):
                    meta["channels"].append(cells[0])
                    meta["exposure"].append(float(cells[3]))
                    meta["number_z_sections"].append(int(cells[4]))
                    meta["z_spacing"].append(float(cells[5]))
                    meta["sectioning_method"].append(cells[6])
            elif section == "devices":
                if len(cells) >= 4 and cells[0] in IMAGING_CHANNELS:
                    meta["device"].append(
                        (cells[0], cells[1], cells[2], float(cells[3]))
                    )
            elif section == "groups" and len(cells) >= 3:
                meta["group"].append(cells[0])
                meta["spatial_locations"].append((float(cells[1]), float(cells[2])))
    return meta


def _grab_time_setting(line: str, meta: dict) -> None:
    for word, key in (
        ("interval", "time_settings/timeinterval"),
        ("frames", "time_settings/ntimepoints"),
    ):
        m = re.findall(rf"{word}:\s*(\d+)", line)
        if m:
            meta.setdefault(key, int(m[0]))
