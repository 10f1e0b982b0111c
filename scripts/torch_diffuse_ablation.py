#!/usr/bin/env python3
"""Where the device time of the port's diffusion kernel goes.

Builds variants of ``aliby_tpu_torch/kernels/csrc/stencil.cu`` (by editing
its source text) beside the kernel as committed, and times each on the
main path's own ``diffuse_heat`` inputs (chip_smoke.py's eight 256x256
fields, one batch of 16, and its 1080x1080 field, 96 rounds): the time a
call (median of 21, CUDA events) and the device time a launch
(torch.profiler). Variants:

- ``kernel``: as committed (non-negative regions skip the masked
  neighbours; the division by two FMAs);
- ``fdiv division``: every division by ``__fdiv_rn``;
- ``exact path only``: every block takes the path that multiplies by the
  0/1 flags, also where its values are all non-negative;
- ``one block an SM``: ``__launch_bounds__`` asks for one block an SM, not
  two (more registers a thread);
- ``unrolled strip``: a thread's strip of 10 rows unrolled, not 2 at a time;
- ``no division``: a multiply by 1/9 in its place, to see what the
  division costs (its output is wrong and is not checked);
- ``no rounds``: the loads alone, no round (output not checked).

The others are held to the plain version (``torch.equal``). Needs one CUDA
card and nvcc; from the repository root:

    python3 scripts/torch_diffuse_ablation.py
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "scripts")]

import chip_smoke as cs  # noqa: E402
from aliby_tpu_torch.kernels import _build  # noqa: E402
from aliby_tpu_torch.ops import stencil  # noqa: E402
from torch_stencil_split import main_path_inputs  # noqa: E402

DIV = "kNonNeg ? div9_nonneg(acc) : div9(acc);"
BOUNDS = "__launch_bounds__(kDThreads, 2)"
FAST = "const bool non_neg = __syncthreads_and(small);"
VARIANTS = {  # name -> (edits, output checked)
    "kernel": ([], True),
    "fdiv division": ([(DIV, "__fdiv_rn(acc, 9.0f);")], True),
    "exact path only": ([(FAST, "const bool non_neg = __syncthreads_and(small) && false;")],
                        True),
    "one block an SM": ([(BOUNDS, "__launch_bounds__(kDThreads, 1)")], True),
    "unrolled strip": ([("#pragma unroll 2", "#pragma unroll")], True),
    "no division": ([(DIV, "acc * 0.11111111f;")], False),
    "no rounds": ([("for (int r = 0; r < rounds; ++r) {", "for (int r = 0; r < 0; ++r) {")],
                  False),
}


def build_variants() -> dict:
    src = (_build.CSRC / "stencil.cu").read_text()
    out_dir = _build.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (edits, _) in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise AssertionError(f"variant {name}: the edit's anchor is not in stencil.cu")
            text = text.replace(old, new)
        stem = name.replace(" ", "_")
        cu, so = out_dir / f"{stem}.cu", out_dir / f"{stem}.so"
        cu.write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        cs.log(f"[build] {name}: " + " | ".join(regs[:2]))
        lib = ctypes.CDLL(str(so))
        lib.diffuse_heat.argtypes = _build.PROTOTYPES["stencil"]["diffuse_heat"]
        lib.diffuse_heat.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_diffuse_ablation: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    libs = build_variants()
    inputs = main_path_inputs()
    n = cs.STENCIL_ROUNDS
    rows = []
    for what, (_, (lab, src)) in inputs.items():
        want = stencil.diffuse_heat_plain(lab, src, n)
        B, H, W = lab.shape

        def call(lib, out=torch.empty_like(src), tmp=torch.empty_like(src),
                 flags=torch.empty(lab.shape, dtype=torch.int16, device=lab.device)):
            _build.check(lib.diffuse_heat(lab.data_ptr(), src.data_ptr(), out.data_ptr(),
                                          tmp.data_ptr(), flags.data_ptr(), B, H, W, n,
                                          _build.stream_of(lab)),
                         "diffuse_heat variant")
            return out

        for name, lib in libs.items():
            got = call(lib)
            cs.sync()
            if VARIANTS[name][1] and not torch.equal(got, want):
                raise AssertionError(f"variant {name} != plain on the {what} inputs")
            ms = cs.cuda_ms(lambda: call(lib))
            parts = cs.device_by_launch(lambda: call(lib))
            rows.append({"variant": name, "inputs": what, "shape": [B, H, W], "ms": ms,
                         "device_ms_per_launch": {k: t for k, (t, _) in parts.items()}})
            cs.log(f"[ablation] {what} {name}: {ms:.4f} ms a call, device per launch "
                   f"{rows[-1]['device_ms_per_launch'] or 'not measured'}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    print(json.dumps({"rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
