"""Grammar-driven parser for legacy multiDGUI / cExperiment logs (a copy of
``aliby_tpu/logparse/grammar.py``, stdlib only).

The reference loads JSON grammars (``logfile_parser/grammars/*.json``) into
a 324-line state machine (``logfile_parser_legacy.py:23-324``). This is a
fresh, smaller machine covering the constructs those grammars use:

- section ``type``: ``table`` (header-mapped or positional typed columns),
  ``regex`` (single capture, typed), ``list`` / ``lists`` (typed value rows),
  ``stop`` (terminate parsing), ``None`` (free multi-line text);
- ``trigger_startswith`` / ``trigger_re`` activation;
- grammar-level ``regex_preprocessing`` applied before trigger checks;
- per-section ``skip`` and ``next_section`` chaining.

Grammars live here as Python dicts (re-authored from the documented log
formats, not copied files).
"""

from __future__ import annotations

import re
from datetime import datetime

_CASTERS = {
    "str": str,
    "int": lambda v: int(float(v)),
    "float": float,
    "bool": lambda v: str(v).strip().lower() in ("1", "true", "yes"),
}


_TABLE_END = object()  # short-row table terminator sentinel


def _cast(value: str, kind: str):
    try:
        return _CASTERS.get(kind, str)(value.strip())
    except (ValueError, TypeError):
        return value.strip()


class GrammarParser:
    def __init__(self, grammar: dict | str):
        if isinstance(grammar, str):
            grammar = GRAMMARS[grammar]
        grammar = dict(grammar)
        config = grammar.pop("@@CONFIG@@", {})
        self.preprocessing = [
            re.compile(r) for r in config.get("regex_preprocessing", [])
        ]
        self.grammar = grammar

    def parse(self, lines) -> dict:
        if hasattr(lines, "read"):
            lines = lines.read().splitlines()
        elif isinstance(lines, (str,)):
            lines = lines.splitlines()
        output: dict = {}
        active: str | None = None
        table_header: list | None = None
        for raw in lines:
            line = raw.strip()
            if not line:
                if active and self.grammar[active].get("type") == "table":
                    active, table_header = None, None
                continue
            stripped = self._preprocess(line)
            hit = self._match_trigger(stripped, line)
            if hit is not None:
                name, remainder = hit
                spec = self.grammar[name]
                if spec.get("type") == "stop":
                    break
                if spec.get("skip"):
                    active = None
                    continue
                active, table_header = name, None
                if spec.get("type") == "regex":
                    # regexes run against the full (preprocessed) line; the
                    # trigger remainder may have eaten part of the pattern
                    target = stripped if stripped is not None else line
                    del remainder
                    self._regex_line(name, spec, target, output)
                    active = spec.get("next_section")
                    if active and self.grammar[active].get("type") == "regex":
                        continue
                    active = None
                continue
            if active is None:
                continue
            spec = self.grammar[active]
            stype = spec.get("type")
            if stype == "table":
                table_header = self._table_line(
                    active, spec, line, table_header, output
                )
                if table_header is _TABLE_END:  # short row: section over
                    # (reference legacy parser rule, logfile_parser_legacy
                    # .py:179 — a row narrower than the header terminates
                    # the table and is dropped)
                    active, table_header = None, None
            elif stype in ("list", "lists"):
                kind = spec.get("map", "float")
                values = [
                    _cast(v, kind) for v in re.split(r"[,\s]+", line) if v
                ]
                if stype == "list":
                    output.setdefault(active, []).extend(values)
                else:
                    output.setdefault(active, []).append(values)
            elif stype is None:
                output[active] = (output.get(active, "") + "\n" + line).strip()
            elif stype == "regex":
                self._regex_line(active, spec, line, output)
        return output

    # -- helpers ------------------------------------------------------------

    def _preprocess(self, line: str):
        for rx in self.preprocessing:
            m = rx.findall(line)
            if len(m) == 1:
                return m[0].strip()
        return None

    def _match_trigger(self, stripped, line):
        for name, spec in self.grammar.items():
            for candidate in filter(None, (stripped, line)):
                if "trigger_startswith" in spec and candidate.startswith(
                    spec["trigger_startswith"]
                ):
                    return name, candidate[len(spec["trigger_startswith"]) :]
                if "trigger_re" in spec and re.search(spec["trigger_re"], candidate):
                    return name, candidate
                if "trigger_contains" in spec and spec["trigger_contains"] in candidate:
                    return name, candidate
        return None

    def _regex_line(self, name, spec, line, output):
        m = re.search(spec["regex"], line)
        if not m:
            return
        groups = m.groups() or (m.group(0),)
        kind = spec.get("map", "str")
        if kind == "datetime":
            for fmt in ("%d-%b-%Y %H:%M:%S", "%Y-%m-%d %H:%M:%S"):
                try:
                    output[name] = datetime.strptime(groups[0], fmt)
                    return
                except ValueError:
                    continue
            output[name] = groups[0]
        else:
            vals = [_cast(g, kind) for g in groups]
            output[name] = vals[0] if len(vals) == 1 else vals

    def _table_line(self, name, spec, line, header, output):
        cells = [c.strip() for c in line.split(",")]
        cmap = spec["column_map"]
        if isinstance(cmap, dict):
            if header is None and spec.get("has_header", True):
                return cells  # this line is the header
            if header is not None and len(cells) < len(header):
                return _TABLE_END
            default = spec.get("default_map", "str")
            row = {}
            for i, cell in enumerate(cells):
                col = header[i] if header and i < len(header) else f"col{i}"
                out_name, kind = cmap.get(col, (col, default))
                row[out_name] = _cast(cell, kind)
            output.setdefault(name, []).append(row)
            return header
        # positional list column map
        row = {
            out_name: _cast(cell, kind)
            for cell, (out_name, kind) in zip(cells, cmap)
        }
        output.setdefault(name, []).append(row)
        return header


# ---------------------------------------------------------------------------
# Built-in grammars (re-authored for the documented legacy formats)
# ---------------------------------------------------------------------------

GRAMMARS: dict[str, dict] = {
    "multiDGUI_acq_format": {
        "channels": {
            "trigger_startswith": "Channels:",
            "type": "table",
            "column_map": {
                "Channel name": ("channel", "str"),
                "Exposure time": ("exposure", "int"),
                "Skip": ("skip", "int"),
                "Z sect.": ("zsect", "int"),
                "Start time": ("start_time", "int"),
                "Camera mode": ("camera_mode", "int"),
                "EM gain": ("em_gain", "int"),
                "Voltage": ("voltage", "float"),
            },
        },
        "zsectioning": {
            "trigger_startswith": "Z_sectioning:",
            "type": "table",
            "column_map": {
                "Sections": ("nsections", "int"),
                "Spacing": ("spacing", "float"),
                "PFSon?": ("pfson", "bool"),
                "AnyZ?": ("anyz", "bool"),
                "Drift": ("drift", "int"),
                "Method": ("zmethod", "int"),
            },
        },
        "time_settings": {
            "trigger_startswith": "Time_settings",
            "type": "table",
            "has_header": False,
            "column_map": [
                ("istimelapse", "bool"),
                ("timeinterval", "int"),
                ("ntimepoints", "int"),
                ("totaltime", "int"),
            ],
        },
        "positions": {
            "trigger_startswith": "Points:",
            "type": "table",
            "column_map": {
                "Position name": ("posname", "str"),
                "X position": ("xpos", "float"),
                "Y position": ("ypos", "float"),
                "Z position": ("zpos", "float"),
                "PFS offset": ("pfsoffset", "float"),
                "Group": ("group", "int"),
            },
            "default_map": "int",
        },
        "npumps": {
            "trigger_startswith": "Syringe pump details:",
            "type": "regex",
            "regex": r"^.*:\s*(\d+)\s*pumps\.*$",
            "map": "int",
        },
        "switchtimes": {
            "trigger_startswith": "Switch times:",
            "type": "list",
            "map": "int",
        },
        "pumprate": {
            "trigger_startswith": "Pump rates:",
            "type": "lists",
            "map": "float",
        },
    },
    "multiDGUI_log_format": {
        "date": {
            "trigger_re": r"^\d{2}-[A-Z][a-z]{2}-\d{4}$",
            "type": "regex",
            "regex": r"^(\d{2}-[A-Z][a-z]{2}-\d{4})$",
        },
        "microscope": {
            "trigger_startswith": "Microscope name is:",
            "type": "regex",
            "regex": r"Microscope name is:\s*(.*)$",
        },
        "acqfile": {
            "trigger_startswith": "Acquisition settings are saved in:",
            "type": "regex",
            "regex": r"saved in:\s*(.*)$",
        },
        "details": {
            "trigger_startswith": "Experiment details:",
            "type": None,
        },
        "expt_start": {
            "trigger_startswith": "Experiment started at:",
            "type": "regex",
            "regex": r"started at:\s*(.*)$",
        },
        "stop": {
            "trigger_startswith": "------Time point_1------",
            "type": "stop",
        },
    },
    "cExperiment_log_format": {
        "@@CONFIG@@": {
            "regex_preprocessing": [
                r"^\d{2}-[A-Z][a-z]{2}-\d{4} \d{2}:\d{2}:\d{2}\s*(.*)$"
            ]
        },
        "extractmethod": {
            "trigger_startswith": "Extracting data using extractionParameters:",
            "type": "regex",
            "regex": r"extractionParameters:\s*(.*)$",
        },
        "segcomplete": {
            "trigger_re": r"Successfully completed segmenting cells",
            "type": "regex",
            "regex": r"(.*)",
        },
    },
}


def dispatch_grammar(filename: str) -> str:
    """Pick a grammar by legacy filename convention."""
    name = str(filename)
    if name.endswith("acq.txt"):
        return "multiDGUI_acq_format"
    if name.endswith("log.txt"):
        return "multiDGUI_log_format"
    return "cExperiment_log_format"
