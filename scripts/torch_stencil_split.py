#!/usr/bin/env python3
"""Time the port's two stencils on the main path's own inputs, on one GPU.

    python3 scripts/torch_stencil_split.py [--tree DIR] [--sass] [--out FILE]

Imports ``aliby_tpu_torch`` from ``--tree`` (default: this repository), so
that two trees (say a parent commit unpacked with ``git archive``) can be
timed by the same code: run them as separate processes, in turns (parent,
change, change, parent). It segments chip_smoke.py's eight 256x256 Cell
Painting fields (2 objects, one batch of 16) and its 1080x1080 field,
records the inputs the segmentation gave ``successor_prop`` and
``diffuse_heat``, and reports for each stencil and shape: the time per call
(median of 21, CUDA events), the launches a call (the wrapper's counter),
the device time of each launch (torch.profiler), the wrapper's host time a
call (200 calls back to back) and the time a call within a run of 50, and
checks the output against the plain version. ``--sass`` also counts the f32
instructions of each stencil kernel in the built library (``cuobjdump``).
The last line is one JSON object; the card's name and power limit come
before it.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_OPCODES = ("FADD", "FMUL", "FFMA", "FCHK", "MUFU", "FSEL", "FSETP")


def sass_counts(lib_path: str) -> dict:
    """{kernel: {opcode: count}} of the f32 opcodes in each kernel's SASS."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    counts: dict[str, collections.Counter] = {}
    kernel = None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            kernel = m.group(1)
            counts[kernel] = collections.Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", line)
        if kernel and m and m.group(1) in F32_OPCODES:
            counts[kernel][m.group(1)] += 1
    return {k: dict(v) for k, v in counts.items()}


def main_path_inputs() -> dict:
    """{"8 fields": ((dcode, key), (labels, source)), "1080x1080": ...}: the
    arguments the segmentation gives the two stencils on chip_smoke.py's
    fields (``aliby_tpu_torch`` and ``chip_smoke`` importable)."""
    import chip_smoke as cs
    from aliby_tpu_torch.models import flows
    from aliby_tpu_torch.models.segment import dispatch_segmenter, segment_grouped
    from aliby_tpu_torch.test_data import cellpainting_fields, cellpainting_large_field

    pixels = np.concatenate(cellpainting_fields(8, 256, seed=7))
    big = cellpainting_large_field(1080, seed=11)
    segs = [dispatch_segmenter("cellpose", 0, second_channel=3),
            dispatch_segmenter("cellpose", 3, second_channel=0)]
    segment_grouped(segs, pixels)  # warm-up
    inputs = {}
    for what, px in (("8 fields", pixels), ("1080x1080", big)):
        recs = [cs.Recorder(flows, "successor_prop"), cs.Recorder(flows, "diffuse_heat")]
        with cs.recording(recs):
            segment_grouped(segs, px)
        inputs[what] = [r.args[:2] for r in recs]
    cs.sync()
    return inputs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=REPO, help="root of the tree whose port is timed")
    ap.add_argument("--sass", action="store_true", help="count the kernels' f32 instructions")
    ap.add_argument("--out", help="also write the JSON result to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_stencil_split: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, REPO)
    import chip_smoke as cs  # this repository's, whatever the tree

    sys.path.insert(0, tree)
    from aliby_tpu_torch.kernels import _build
    from aliby_tpu_torch.ops import stencil

    if not _build.__file__.startswith(tree):
        raise AssertionError(f"imported {_build.__file__}, not from {tree}")
    inputs = main_path_inputs()

    n = cs.STENCIL_ROUNDS
    rows = []
    for what, ((d, k), (lab, src)) in inputs.items():
        calls = {"successor_prop": (lambda: stencil.successor_prop(d, k, n_prop=n),
                                    lambda: stencil.successor_prop_plain(d, k, n_prop=n),
                                    stencil.successor_prop),
                 "diffuse_heat": (lambda: stencil.diffuse_heat(lab, src, n),
                                  lambda: stencil.diffuse_heat_plain(lab, src, n),
                                  stencil.diffuse_heat)}
        for name, (fn, plain, wrapper) in calls.items():
            got, want = fn(), plain()
            cs.sync()
            if not torch.equal(got, want):
                raise AssertionError(f"{name} != plain on the {what} inputs")
            before = wrapper.launches
            fn()
            per_call = wrapper.launches - before
            ms = cs.cuda_ms(fn)
            parts = cs.device_by_launch(fn)
            row = {"name": name, "inputs": what, "shape": list(d.shape), "ms": ms,
                   "launches_per_call": per_call,
                   "device_ms_per_launch": {p: t for p, (t, _) in parts.items()},
                   "host_ms": cs.host_ms_per_call(fn), "ms_in_a_run": cs.run_ms_per_call(fn)}
            rows.append(row)
            cs.log(f"[split] {name} {what} {tuple(d.shape)}: {ms:.4f} ms a call, {per_call} "
                   f"launches, device per launch {row['device_ms_per_launch'] or 'not measured'}, "
                   f"host {row['host_ms']:.4f} ms, in a run {row['ms_in_a_run']:.4f} ms")
    result = {"tree": tree, "rows": rows}
    if args.sass:
        result["sass_f32"] = sass_counts(str(_build.library_path("stencil")))
        for kernel, c in result["sass_f32"].items():
            cs.log(f"[sass] {kernel}: {c}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    result["card"] = smi.splitlines()[0]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(result["card"], flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
