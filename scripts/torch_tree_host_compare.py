#!/usr/bin/env python3
"""Host-bound costs of one checkout of the port, on one GPU, so that two
checkouts (say a parent commit unpacked with ``git archive``) can be
compared in alternating processes of one machine:

    for t in parent change change parent; do python3 scripts/torch_tree_host_compare.py $t; done

Imports ``aliby_tpu_torch`` from the checkout given as the first argument
and builds its kernels. Prints one JSON object: the import time, the host
cost of one small plain PyTorch op on the card (µs an add of 64 floats,
the median of 5 runs of 20,000; no code of the checkout runs in it, so it
reads the host's own drift), ``segment_grouped`` of chip_smoke.py's
phase 3 (8 Cell Painting fields of 256², 2 objects; median and least of
15 calls after a warm-up, each ending in a synchronize) and the host time
of one ``successor_prop`` wrapper call (16 x 256², 96 rounds; 500 calls
issued back to back). A second argument ``dist`` imports
``torch.distributed`` first.
"""

import json
import statistics
import sys
import time

root, extra = sys.argv[1], sys.argv[2:]
t_imp = time.perf_counter()
if "dist" in extra:
    import torch.distributed  # noqa: F401
sys.path.insert(0, root)
import numpy as np  # noqa: E402
import torch  # noqa: E402

from aliby_tpu_torch.kernels import _build  # noqa: E402
from aliby_tpu_torch.models.segment import dispatch_segmenter, segment_grouped  # noqa: E402
from aliby_tpu_torch.ops import stencil  # noqa: E402
from aliby_tpu_torch.test_data import cellpainting_fields  # noqa: E402

t_imp = time.perf_counter() - t_imp
_build.build()
dev = torch.device("cuda")
sync = torch.cuda.synchronize
x = torch.ones(64, device=dev)
sync()
loop = []
for _ in range(5):
    t = time.perf_counter()
    for _ in range(20000):
        x = x + 1
    sync()
    loop.append((time.perf_counter() - t) / 20000 * 1e6)
pixels = np.concatenate(cellpainting_fields(8, 256, seed=7))
nuc = dispatch_segmenter("cellpose", 0, second_channel=3)
cell = dispatch_segmenter("cellpose", 3, second_channel=0)
segment_grouped([nuc, cell], pixels)
sync()
times = []
for _ in range(15):
    t = time.perf_counter()
    segment_grouped([nuc, cell], pixels)
    sync()
    times.append((time.perf_counter() - t) * 1e3)
d = torch.randint(0, 9, (16, 256, 256), device=dev, dtype=torch.int32)
k = torch.arange(16 * 256 * 256, device=dev, dtype=torch.int32).reshape(16, 256, 256)
stencil.successor_prop(d, k, 96)
sync()
t = time.perf_counter()
for _ in range(500):
    stencil.successor_prop(d, k, 96)
host = (time.perf_counter() - t) / 500 * 1e3
sync()
print(json.dumps({"tree": root, "extra": extra, "import_s": round(t_imp, 3),
                  "us_per_add": round(statistics.median(loop), 3),
                  "slice_ms_median": round(statistics.median(times), 2),
                  "slice_ms_min": round(min(times), 2),
                  "succ_host_ms": round(host, 4)}), flush=True)
