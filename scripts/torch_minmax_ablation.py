"""Where the device time of the port's per-bin min/max kernel goes.

Builds variants of ``aliby_tpu_torch/kernels/csrc/segsum.cu`` (by editing
its source text) beside the kernel as committed, and times one launch of
each (torch.profiler, device time per launch) on (16, 65,536) pixels of
label images like the feature bank's (the test fields' labels tiled) and
on uniform bins, 65 bins:

- ``kernel``: as committed (per-thread runs, one update per run);
- ``warp match``: the runs of a warp that end at the same pixel in the same
  bin meet through ``__match_any_sync`` and ``__reduce_*_sync`` first, and
  one lane updates;
- ``warp one bin``: the warp reduces its ending runs when they all lie in
  one bin, and updates per lane otherwise;
- ``no last-block fold``, ``no run updates``, ``loads only``: the kernel
  with parts removed, to see what each costs (their outputs are wrong and
  are not checked).

The first three are held to the plain version (equal, NaN positions
equal). Needs one CUDA card and nvcc; from the repository root:

    python3 scripts/torch_minmax_ablation.py
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from aliby_tpu_torch.kernels import _build  # noqa: E402
from aliby_tpu_torch.ops import segsum  # noqa: E402
from aliby_tpu_torch.test_data import render_cells  # noqa: E402

PER_LANE = """    if (ends) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int slot = bin[u] * K + k0 + c;
        if (run_mn[c] < s_tab[slot]) atomicMin(&s_tab[slot], run_mn[c]);
        if (run_mx[c] > s_tab[slots + slot]) atomicMax(&s_tab[slots + slot], run_mx[c]);
      }
    }
"""
WARP_MATCH = """    if (__any_sync(0xffffffffu, ends)) {
      const unsigned grp = __match_any_sync(0xffffffffu, ends ? bin[u] : -1);
      if (ends) {
        const bool leader = (threadIdx.x & 31) == __ffs(grp) - 1;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int32_t gmn = __reduce_min_sync(grp, run_mn[c]);
          const int32_t gmx = __reduce_max_sync(grp, run_mx[c]);
          const int slot = bin[u] * K + k0 + c;
          if (leader && gmn < s_tab[slot]) atomicMin(&s_tab[slot], gmn);
          if (leader && gmx > s_tab[slots + slot]) atomicMax(&s_tab[slots + slot], gmx);
        }
      }
    }
"""
WARP_ONE_BIN = """    const unsigned enders = __ballot_sync(0xffffffffu, ends);
    if (enders) {
      const int first = __ffs(enders) - 1;
      const int b0 = __shfl_sync(0xffffffffu, bin[u], first);
      if (__all_sync(0xffffffffu, !ends || bin[u] == b0)) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int32_t gmn = __reduce_min_sync(0xffffffffu, ends ? run_mn[c] : kPosInfKey);
          const int32_t gmx = __reduce_max_sync(0xffffffffu, ends ? run_mx[c] : kNegInfKey);
          const int slot = b0 * K + k0 + c;
          if ((threadIdx.x & 31) == first && gmn < s_tab[slot]) atomicMin(&s_tab[slot], gmn);
          if ((threadIdx.x & 31) == first && gmx > s_tab[slots + slot])
            atomicMax(&s_tab[slots + slot], gmx);
        }
      } else {
""" + PER_LANE.replace("\n    ", "\n        ").replace("    if (ends) {", "        if (ends) {", 1) + """      }
    }
"""
FOLD = "      fold_runs<NC>(bin, x, 0, NC, slots, s_tab);\n"
NO_FOLD = "      if (x[0] == 12345.0f && bin[0] == 7) s_tab[0] = 0;  // keeps the loads\n"
TAIL = "  if (!s_last) return;\n"


def variants(src: str) -> dict[str, tuple[str, bool]]:
    """name -> (source, whether its output is checked)."""
    for part in (PER_LANE, FOLD, TAIL):
        if part not in src:
            raise RuntimeError("segsum.cu no longer holds the text this script edits")
    return {
        "kernel": (src, True),
        "warp match": (src.replace(PER_LANE, WARP_MATCH), True),
        "warp one bin": (src.replace(PER_LANE, WARP_ONE_BIN), True),
        "no last-block fold": (src.replace(TAIL, "  return;\n"), False),
        "no run updates": (src.replace(FOLD, NO_FOLD), False),
        "loads only": (src.replace(FOLD, NO_FOLD).replace(TAIL, "  return;\n"), False),
    }


def build(named: dict[str, tuple[str, bool]], out_dir: str) -> dict[str, ctypes.CDLL]:
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, (text, _)) in enumerate(named.items()):
        cu = os.path.join(out_dir, f"minmax_variant{i}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = cu[:-3] + ".so"
        procs[name] = (subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
                                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(so)
        lib.binned_minmax.argtypes = _build.PROTOTYPES["segsum"]["binned_minmax"]
        lib.binned_minmax.restype = ctypes.c_int
        libs[name] = lib
    return libs


def call(lib, v, b, n_bins):
    B, N, K = v.shape
    slots = n_bins * K
    G, n_part = segsum.minmax_scratch(B, N, slots)
    out = torch.empty(2, B, n_bins, K, device=v.device)
    part = torch.empty(n_part, dtype=torch.int32, device=v.device)
    _build.check(lib.binned_minmax(v.data_ptr(), b.data_ptr(), out.data_ptr(),
                                   out.data_ptr() + 4 * B * slots, part.data_ptr(), B, N, K,
                                   n_bins, G, _build.stream_of(v)), "binned_minmax variant")
    return out[0], out[1]


def device_us(fn, calls: int = 30, windows: int = 3) -> float:
    """Device time of one launch (the mean over the launches recorded)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = (0, 0.0)
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and e.count > best[0]:
                best = (e.count, e.self_device_time_total / e.count)
    return best[1]


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_minmax_ablation: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    with open(os.path.join(ROOT, "aliby_tpu_torch", "kernels", "csrc", "segsum.cu")) as f:
        named = variants(f.read())
    libs = build(named, os.path.join(ROOT, "build", "minmax_ablation"))
    rng = np.random.default_rng(0)
    base = [render_cells(256, 24, rng)[2].reshape(-1) for _ in range(4)]
    labels = torch.from_numpy(np.stack([base[i % 4] for i in range(16)]).astype(np.int32)).to(dev)
    yy, xx = np.mgrid[0:256, 0:256].astype(np.float32)
    bbox = np.broadcast_to(np.stack([yy, xx], -1).reshape(1, -1, 2), (16, 65536, 2)).copy()
    normal = rng.normal(0, 50, (16, 65536, 2)).astype(np.float32)
    uniform = rng.integers(-1, 66, (16, 65536)).astype(np.int32)
    cases = {
        "label images, bbox coordinates, K 2": (torch.from_numpy(bbox).to(dev), labels),
        "label images, K 1": (torch.from_numpy(normal[..., :1].copy()).to(dev), labels),
        "label images, K 2": (torch.from_numpy(normal).to(dev), labels),
        "uniform bins, K 2": (torch.from_numpy(normal).to(dev), torch.from_numpy(uniform).to(dev)),
    }
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)} ({smi}); device us per launch, (16, 65536) px, "
          f"65 bins", flush=True)
    for what, (v, b) in cases.items():
        want = segsum.binned_minmax_batched_plain(v, b, 65)
        row = []
        for name, lib in libs.items():
            if named[name][1]:
                got = call(lib, v, b, 65)
                for g, w in zip(got, want):
                    nan = torch.isnan(w)
                    if not (torch.equal(torch.isnan(g), nan) and torch.equal(g[~nan], w[~nan])):
                        raise AssertionError(f"{name} != plain on {what}")
            row.append(f"{name} {device_us(lambda: call(lib, v, b, 65)):.2f}")
        print(f"{what}: " + ", ".join(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
