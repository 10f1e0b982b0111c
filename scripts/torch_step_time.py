#!/usr/bin/env python3
"""Time the port's fused step as chip_smoke.py's phase 3 does, on one GPU.

    python3 scripts/torch_step_time.py [--tree DIR] [--reps N] [--out FILE]

Imports ``aliby_tpu_torch`` from ``--tree`` (default: this repository), so
that two trees (say a parent commit unpacked with ``git archive``) can be
timed by the same code: run them as separate processes, in turns (parent,
change, change, parent). It builds the tree's kernels and times, as the
median of ``--reps`` wall-clock calls after one warm-up (each call ends in
its readback), ``try_compile(...).fused`` of the example-01 and the
default-bank pipelines on chip_smoke.py's eight 256x256 Cell Painting
fields, and of the default bank on its 1080x1080 field.

Where the tree runs the U-Net in fixed micro-batches
(``models.segment.UNET_BATCH_PIXELS``), it also times what that costs the
small calls of the per-timepoint and movie paths: the default-bank step on
1 and 3 fields of 256x256 (2 and 6 images, padded to a micro-batch of 16)
with the tree's ``CellposeTorch._forward`` and with one forward of the
unpadded batch, and the U-Net forward alone at 2, 6 and 16 images (CUDA
events). The last line is one JSON object; the card's name and power limit
come before it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=REPO, help="root of the tree whose port is timed")
    ap.add_argument("--reps", type=int, default=7, help="timed calls a step (median)")
    ap.add_argument("--out", help="also write the JSON result to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_step_time: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, REPO)
    import chip_smoke as cs  # this repository's, whatever the tree

    sys.path.insert(0, tree)
    from aliby_tpu_torch.engine.builders import build_pipeline_steps
    from aliby_tpu_torch.engine.compiled import try_compile
    from aliby_tpu_torch.kernels import _build
    from aliby_tpu_torch.models import segment
    from aliby_tpu_torch.test_data import cellpainting_fields, cellpainting_large_field

    if not _build.__file__.startswith(tree):
        raise AssertionError(f"imported {_build.__file__}, not from {tree}")
    _build.build()
    fields = np.concatenate(cellpainting_fields(8, 256, seed=7))
    big = cellpainting_large_field(1080, seed=11)
    result = {"tree": tree, "steps_ms": {}}
    steps = {what: try_compile(build_pipeline_steps(**kw), device="cuda")
             for what, kw in (("example-01", cs.EXAMPLE01), ("default bank", cs.DEFAULT_BANK))}

    def step_ms(what, step, pixels):
        step.fused(pixels)  # warm-up
        ms = cs.host_ms(lambda: step.fused(pixels), reps=args.reps)
        result["steps_ms"][what] = ms
        cs.log(f"[step] {what}: {ms:.2f} ms (median of {args.reps})")

    step_ms("example-01, 8 x 256^2", steps["example-01"], fields)
    step_ms("default bank, 8 x 256^2", steps["default bank"], fields)
    step_ms("default bank, 1080^2", steps["default bank"], big)
    for n in (1, 3):
        step_ms(f"default bank, {n} x 256^2", steps["default bank"], fields[:n])

    if hasattr(segment, "UNET_BATCH_PIXELS"):
        engine = segment.CellposeTorch
        padded = engine._forward
        engine._forward = lambda self, x: self.model(x)
        try:
            for n in (1, 3):
                step_ms(f"default bank, {n} x 256^2, one unpadded forward",
                        steps["default bank"], fields[:n])
        finally:
            engine._forward = padded
        model = segment.dispatch_segmenter("cellpose", 0, second_channel=3).engine.model
        x = torch.randn(16, 256, 256, 2, device="cuda")
        with torch.no_grad():
            result["unet_ms"] = {n: cs.cuda_ms(lambda n=n: model(x[:n])) for n in (2, 6, 16)}
        cs.log(f"[unet] one forward at 256^2 by images: {result['unet_ms']} ms (CUDA events)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    result["card"] = smi.splitlines()[0]
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    print(result["card"])
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
