"""Train the flagship CellposeNet with the PyTorch port on synthetic fields.

    python scripts/torch_train_flagship.py [n_steps] [--budding F] [--nuclei F]
        [--lr LR] [--fresh] [--out PATH]

The counterpart of ``scripts/train_flagship.py``: batch 8 at 128x128, AdamW
(optax's defaults) on a cosine schedule with alpha 0.05, peak 5e-4 when it
resumes from the bundled weights and 2e-3 with ``--fresh`` (a fresh
cosine at 2e-3 on warm weights spikes the loss). ``--budding F`` mixes a
share F of budding-yeast frames into the batches, ``--nuclei F`` one of
nuclei-as-main frames. It writes the f16 Flax msgpack that the JAX package
reads to ``--out`` (default ``build/cellpose_synthetic.candidate.msgpack``)
and prints the held-out IoU (plain fields, budding movies, nuclei) of the
candidate and, when resumed, of the bundled weights. It never writes the
bundled checkpoint. Runs on the card.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_steps", nargs="?", type=int, default=400)
    ap.add_argument("--budding", type=float, default=0.0)
    ap.add_argument("--nuclei", type=float, default=0.0)
    ap.add_argument("--lr", type=float, default=None, help="peak learning rate")
    ap.add_argument("--fresh", action="store_true", help="start from init_params(seed=0)")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "cellpose_synthetic.candidate.msgpack")
    args = ap.parse_args(argv)

    from aliby_tpu_torch.device import resolve_device
    from aliby_tpu_torch.models.training import (
        adamw,
        cosine_decay_schedule,
        load_params,
        make_train_step,
        save_params,
        synthetic_batch,
    )
    from aliby_tpu_torch.models.unet import init_params
    from aliby_tpu_torch.models.weights import BUNDLED_WEIGHTS

    if args.out.resolve() == BUNDLED_WEIGHTS.resolve():
        raise SystemExit("--out must not be the bundled checkpoint")
    dev = resolve_device()
    seed = int(time.time()) % 2**16
    print(f"device {dev}, batch seed {seed}", flush=True)
    rng = np.random.default_rng(seed)
    model = init_params(0, in_channels=2, size=128, device=dev)
    resumed = BUNDLED_WEIGHTS.exists() and not args.fresh
    if resumed:
        model.load_state_dict(load_params(BUNDLED_WEIGHTS, model))
        print("resuming from bundled weights", flush=True)
    peak_lr = args.lr if args.lr is not None else (5e-4 if resumed else 2e-3)
    optimizer, scheduler = adamw(model.parameters(),
                                 cosine_decay_schedule(peak_lr, args.n_steps, 0.05))
    step = make_train_step(model, optimizer, scheduler)

    t0 = time.time()
    for i in range(args.n_steps):
        batch = synthetic_batch(rng, batch=8, size=128, budding_frac=args.budding,
                                nuclei_frac=args.nuclei, device=dev)
        metrics = step(batch)
        if (i + 1) % 25 == 0 or i == 0:
            print(f"step {i + 1}/{args.n_steps} loss={float(metrics['loss']):.4f} "
                  f"flow={float(metrics['flow_loss']):.4f} "
                  f"prob={float(metrics['prob_loss']):.4f} ({time.time() - t0:.0f}s)",
                  flush=True)

    save_params(model, args.out)
    print(f"saved {args.out}", flush=True)
    new = heldout_iou(args.out, dev)
    old = heldout_iou(BUNDLED_WEIGHTS, dev) if resumed else None
    print(f"held-out IoU: bundled={old} candidate={new}", flush=True)
    return 0


def heldout_iou(weights_path, device, n_plain: int = 6, n_budding: int = 6) -> dict:
    """Mean best-match IoU per ground-truth object on fixed held-out renders
    (``scripts/train_flagship.py`` ``heldout_iou``), with the flow-error QC
    on (0.4)."""
    from aliby_tpu_torch.models.segment import CellposeTorch
    from aliby_tpu_torch.models.training import heldout_scores, heldout_sets

    eng = CellposeTorch(pretrained_path=weights_path, flow_threshold=0.4, device=device)
    return heldout_scores(eng.segment_tiles, heldout_sets(n_plain, n_budding))


if __name__ == "__main__":
    sys.exit(main())
