#!/usr/bin/env python3
"""Which stage of the fused step changes its bits with the batch size, on
one CUDA card.

    python3 scripts/torch_batch_identity.py      # from the repository root

On three Cell Painting fields (256² and 1080²) it compares, stage by stage,
a batch of three with the three fields one at a time:

- the U-Net forward (``CellposeTorch.model``) at batch 3 against batch 1;
- mask reconstruction (``models.flows.masks_from_flows``) on the same
  network outputs;
- the default bank's feature trees (``extract.tree_collect``) on the same
  labels;
- the U-Net at the fixed micro-batch that ``CellposeTorch._forward`` uses
  for the image size (16 images at 256², 1 at 1080²): each of the three
  fields at another place in the batch, beside other images or zero
  images;
- the fused step (``try_compile(...).fused``), whose U-Net runs in those
  micro-batches, at batch 3 against batch 1.

It prints, for each, whether the bits agree, and the card's name and power
limit. Exits non-zero without CUDA.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    a, b = a.float(), b.float()
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan]))


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_batch_identity: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from aliby_tpu_torch.engine.builders import build_pipeline_steps
    from aliby_tpu_torch.engine.compiled import try_compile
    from aliby_tpu_torch.extract.extract import reduce_z_traced, tree_collect
    from aliby_tpu_torch.models.flows import _div, masks_from_flows
    from aliby_tpu_torch.models.segment import (
        UNET_BATCH_PIXELS,
        _normalize_percentile,
        dispatch_segmenter,
    )
    from aliby_tpu_torch.test_data import cellpainting_fields, cellpainting_large_field

    dev = torch.device("cuda")
    step = try_compile(build_pipeline_steps(channels_to_segment={"nuclei": 0, "cell": 3},
                                            channels_to_extract=[0, 1, 2, 3, 4]))
    engine = dispatch_segmenter("cellpose", 0).engine  # the step's engine (one cache)
    makers = {256: lambda s: cellpainting_fields(1, 256, seed=s)[0],
              1080: lambda s: cellpainting_large_field(1080, seed=s)}
    for size, make in makers.items():
        fields = np.concatenate([make(11 + i) for i in range(3)])  # (3, 5, 1, S, S)
        px = torch.from_numpy(fields).to(dev)
        images = torch.stack([px[:, 0, 0], px[:, 3, 0]], dim=1)  # (3, 2, S, S)
        with torch.no_grad():
            x = _normalize_percentile(images.permute(0, 2, 3, 1).float())
            one = [engine.model(x[i:i + 1]) for i in range(3)]
            again = [engine.model(x[i:i + 1]) for i in range(3)]
            three = engine.model(x)
            print(f"[batch] {size}^2 U-Net: batch 1 twice the same bits: "
                  f"{all(same(a, b) for a, b in zip(one, again))}; batch 3 vs batch 1 the same "
                  f"bits: {[same(three[i:i + 1], one[i]) for i in range(3)]}", flush=True)
            m = max(1, min(16, UNET_BATCH_PIXELS // (size * size)))
            if m > 1:
                rng = np.random.default_rng(size)
                others = x[rng.permutation(np.arange(3).repeat(m))[:m - 3]] * 0.5
                a = torch.cat([x, others])  # the fields first, other images after
                b = torch.cat([torch.zeros_like(others), x.flip(0)])  # last, reversed, zeros
                pa, pb = engine.model(a), engine.model(b)
                placed = [same(pa[i], pb[m - 1 - i]) for i in range(3)]
            else:
                placed = [same(engine.model(x[i:i + 1]), one[i]) for i in range(3)]
            print(f"[batch] {size}^2 U-Net at its micro-batch of {m}: the same bits at another "
                  f"place and beside other images: {placed}", flush=True)
            pred = torch.cat(one)
            flows = _div(torch.stack([pred[..., 0], pred[..., 1]], dim=1), 5.0)

            def labels_of(k):
                return masks_from_flows(
                    flows[k], pred[k][..., 2], cellprob_threshold=engine.cellprob_threshold,
                    n_iter=engine.flow_iters, max_labels=engine.max_labels,
                    min_size=engine.min_size, flow_threshold=engine.flow_threshold,
                    fill_holes=engine.fill_holes)

            lab3 = labels_of(slice(0, 3))
            lab1 = torch.cat([labels_of(slice(i, i + 1)) for i in range(3)])
            print(f"[batch] {size}^2 masks_from_flows: batch 3 vs batch 1 the same bits: "
                  f"{[bool(torch.equal(lab3[i], lab1[i])) for i in range(3)]}", flush=True)
            for ti in range(2):
                _insts, entries, slot_of, _lookup = step.fused.plans[0][ti]
                imgs = [None] * len(slot_of)
                for (ch, rz), si in slot_of.items():
                    imgs[si] = reduce_z_traced(px[:, ch], rz, dim=1)
                f3 = tree_collect(entries, lab1, imgs, 256)[1]
                f1 = torch.cat([tree_collect(entries, lab1[i:i + 1], [im[i:i + 1] for im in imgs],
                                             256)[1] for i in range(3)], dim=1)
                print(f"[batch] {size}^2 tree {ti} ({f3.shape[0]} features x 256 labels): "
                      f"batch 3 vs batch 1 the same bits: {same(f3, f1)}", flush=True)
        out3 = step.fused(fields)
        out1 = [step.fused(fields[i:i + 1]) for i in range(3)]
        labels_same = [bool(np.array_equal(out3["labels"][o][i], out1[i]["labels"][o][0]))
                       for i in range(3) for o in range(2)]
        feats_same = all(
            np.array_equal(a3[:, i], o1["features"][o][t][1][:, 0], equal_nan=True)
            for o in range(2) for t, (_n, a3) in enumerate(out3["features"][o])
            for i, o1 in enumerate(out1))
        print(f"[batch] {size}^2 fused step (U-Net in micro-batches): batch 3 vs batch 1 "
              f"labels the same bits: {labels_same}; features: {feats_same}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
