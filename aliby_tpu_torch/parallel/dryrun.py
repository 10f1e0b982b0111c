"""Multi-device dry run (counterpart of ``__graft_entry__.dryrun_multichip``)
and the rank processes it spawns.

:func:`dryrun_multichip` runs the reference's three parts over ``n``
devices: one sharded train step at widths (8, 16, 32) on 32x32 fields
(``sp = 2`` when n is even), ``run_positions_mesh`` on ``max(n, 2)``
synthetic 64x64 positions, and a sharded inference forward (the batch over
dp, rows over sp). The train step and the forward run in ``n`` processes
of one ``torch.distributed`` group (:func:`spawn_ranks`: a ``file://``
rendezvous in a temporary directory, one rank a device); the runner runs in
the calling process, over the mesh's dp devices from threads.

The backend is the caller's: ``"nccl"`` when each rank has its own card
(the default there), ``"gloo"`` on the CPU (the default there) and for a
rehearsal of several ranks on one card, which the caller asks for: NCCL
refuses two ranks on one GPU, and asking for it raises. Nothing switches
backend silently.

The rank function and its parts live here, not in a test module, so that
the spawned processes import only this package.
"""

from __future__ import annotations

import math
import os
import tempfile
import time
from contextlib import nullcontext
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from aliby_tpu_torch.device import resolve_device
from aliby_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_batch, sp_rows


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def make_model(feats: Sequence[int], dtype: str, weights: str | None, seed: int, device):
    """A U-Net at ``feats`` widths in ``dtype`` ("float32" or "bfloat16"):
    the bundled flagship checkpoint with ``weights="bundled"``, else
    ``init_params(seed)``."""
    from aliby_tpu_torch.models.unet import CellposeNet, init_params
    from aliby_tpu_torch.models.weights import (
        BUNDLED_WEIGHTS,
        params_from_flax,
        read_flax_checkpoint,
    )

    dt = getattr(torch, dtype)
    if weights == "bundled":
        model = CellposeNet(base_features=tuple(feats), dtype=dt)
        model.load_state_dict(params_from_flax(read_flax_checkpoint(BUNDLED_WEIGHTS)))
        return model.to(device)
    return init_params(seed, in_channels=2, device=device, base_features=tuple(feats), dtype=dt)


def forward_inputs(batch: int, size: int, seed: int) -> np.ndarray:
    """(batch, size, size, 2) f32 U-Net inputs: the DNA and AGP channels of
    Cell Painting fields at the bench's density
    (``test_data.cellpainting_large_field``, seeds ``seed``, ``seed + 1``,
    ...), each channel over its 99th percentile."""
    from aliby_tpu_torch.test_data import cellpainting_large_field

    images = []
    for i in range(batch):
        field = cellpainting_large_field(size, seed=seed + i)[0, :, 0]
        x = np.stack([field[0], field[3]], -1).astype(np.float32)
        images.append(x / np.maximum(np.percentile(x, 99.0, axis=(0, 1)), 1e-6))
    return np.stack(images).astype(np.float32)


def train_part(mesh: Mesh, feats, size: int, batch: int, steps: int, seed: int = 0,
               lr: float = 1e-3, dtype: str = "float32", weights: str | None = None) -> dict:
    """``steps`` sharded train steps from ``seed`` (the model's init and the
    numpy draws of ``synthetic_batch``, which every rank renders in full);
    returns each step's metrics and seconds, the global gradient of the
    first batch (before any step), the parameters after, and this rank's
    ``diffuse_heat`` launches (the targets)."""
    from aliby_tpu_torch.models.training import adamw, make_sharded_train_step, synthetic_batch
    from aliby_tpu_torch.ops import stencil

    dev = mesh.devices[mesh.coords()]
    model = make_model(feats, dtype, weights, seed, dev)
    optimizer, scheduler = adamw(model.parameters(), lr)
    step, _ = make_sharded_train_step(model, optimizer, scheduler, mesh)
    rng = np.random.default_rng(seed)
    before = stencil.diffuse_heat.launches
    metrics, seconds, grads = [], [], {}
    for i in range(steps):
        b = synthetic_batch(rng, batch, size, device=dev)
        if i == 0:
            step.gradients(b)
            grads = {n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()}
            optimizer.zero_grad(set_to_none=True)
        _sync(dev)
        t0 = time.perf_counter()
        m = step(b)
        _sync(dev)
        seconds.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "seconds": seconds, "grads": grads,
            "params": {k: v.detach().cpu() for k, v in model.state_dict().items()},
            "diffuse_heat": stencil.diffuse_heat.launches - before}


def forward_part(mesh: Mesh, feats, size: int, batch: int, seed: int = 0,
                 dtype: str = "float32", weights: str | None = None, images: str = "fields",
                 model_seed: int = 0, reps: int = 1) -> dict:
    """This rank's block of a sharded forward of ``batch`` images
    (:func:`forward_inputs`, or zeros with ``images="zeros"``): the batch
    over dp, rows over sp. Returns the block's prediction, where it lies
    (its batch and row slices) and the seconds of the last of ``reps``
    forwards."""
    from aliby_tpu_torch.models.cpnet import tf32_off
    from aliby_tpu_torch.parallel.mesh import block_slices
    from aliby_tpu_torch.parallel.spatial import SpatialShard

    dev = mesh.devices[mesh.coords()]
    _, s = mesh.coords()
    sp = mesh.shape["sp"]
    model = make_model(feats, dtype, weights, model_seed, dev).eval()
    unit = 2 ** (len(feats) - 1)
    x = (np.zeros((batch, size, size, 2), np.float32) if images == "zeros"
         else forward_inputs(batch, size, seed))
    spec = ("dp", "sp", None, None)
    block = torch.from_numpy(np.ascontiguousarray(shard_batch(mesh, x, spec=spec, unit=unit)))
    shard = SpatialShard(mesh.sp_group, s, sp_rows(size, sp, unit)) if sp > 1 else None
    where = block_slices(x.shape, spec, mesh, mesh.rank, unit)[:2]
    with torch.no_grad(), (tf32_off() if dev.type == "cuda" and dtype == "float32"
                           else nullcontext()):
        block = block.to(dev)
        for _ in range(reps):
            _sync(dev)
            t0 = time.perf_counter()
            pred = model(block, sp=shard)
            _sync(dev)
            seconds = time.perf_counter() - t0
    return {"pred": pred.float().cpu(), "batch": (where[0].start, where[0].stop),
            "rows": (where[1].start, where[1].stop), "seconds": seconds}


PARTS = {"train": train_part, "forward": forward_part}


def rank_main(rank: int, cfg: dict) -> None:
    """One rank: join the group (``cfg``: ``backend``, ``init``, ``world``,
    ``dp``, ``sp``, ``devices`` one a rank, ``parts`` [{"name", "kind",
    "args"}], ``out``), run the parts in order, and write their results to
    ``out/rank<rank>.pt``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(cfg["backend"], init_method=cfg["init"],
                            world_size=cfg["world"], rank=rank)
    try:
        mesh = Mesh.from_process_group(cfg["dp"], cfg["sp"], device=cfg["devices"][rank])
        results = {part["name"]: PARTS[part["kind"]](mesh, **part["args"])
                   for part in cfg["parts"]}
        dist.barrier()
        torch.save(results, os.path.join(cfg["out"], f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(parts: list[dict], devices: Sequence, dp: int, sp: int,
                backend: str) -> list[dict]:
    """Run ``parts`` in ``len(devices)`` spawned ranks (rank r on
    ``devices[r]``) of a ``(dp, sp)`` mesh; returns each rank's results."""
    world = len(devices)
    if dp * sp != world:
        raise ValueError(f"dp({dp}) * sp({sp}) != {world} ranks")
    with tempfile.TemporaryDirectory(prefix="aliby_ranks_") as tmp:
        cfg = {"backend": backend, "init": f"file://{tmp}/rendezvous", "world": world,
               "dp": dp, "sp": sp, "devices": [str(d) for d in devices], "parts": parts,
               "out": tmp}
        torch.multiprocessing.spawn(rank_main, args=(cfg,), nprocs=world, join=True)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=True)
                for r in range(world)]


def assemble(blocks: Sequence[dict], batch: int, size: int) -> torch.Tensor:
    """The whole (batch, size, size, C) prediction from the ranks'
    :func:`forward_part` blocks."""
    C = blocks[0]["pred"].shape[-1]
    out = torch.full((batch, size, size, C), float("nan"))
    for b in blocks:
        out[b["batch"][0]:b["batch"][1], b["rows"][0]:b["rows"][1]] = b["pred"]
    return out


def _positions(root: Path, n_pos: int) -> list[dict]:
    """``n_pos`` synthetic 64x64 two-channel positions in zarr stores, as
    the reference's dry run writes them."""
    from aliby_tpu_torch.io import zarrlite
    from aliby_tpu_torch.test_data import render_cells

    rng = np.random.default_rng(0)
    positions = []
    for i in range(n_pos):
        cells, nuclei, _ = render_cells(64, 4, rng)
        stack = np.stack([cells, nuclei])[None][:, :, None].astype(np.float32)
        zarrlite.write_array(root / f"pos{i:02d}", stack)
        positions.append({"key": f"pos{i:02d}", "path": str(root / f"pos{i:02d}")})
    return positions


DRYRUN_PIPELINE = {
    "steps": {
        "tile": {"tile_size": None, "track_drift": False},
        "segment_cell": {
            # the reference's small static bounds; flow_threshold=None: the
            # flow-error QC drops marginal masks of these tiny 64x64 renders
            # at flow_iters=4, and the dry run checks that the sharded path
            # runs, not mask quality
            "segmenter_kwargs": {"kind": "cellpose", "min_size": 8, "max_labels": 32,
                                 "flow_iters": 4, "flow_threshold": None},
            "channel_to_segment": 1,
        },
        "extract_cell": {"tree": {"None": {"None": ["area"]}, 1: {"max": ["mean"]}},
                         "kwargs": {}},
    },
    "passed_data": {"extract_cell": [("masks", "segment_cell"), ("pixels", "tile")]},
    "passed_methods": {"segment_cell": ("tile", "get_fczyx")},
    "save": [],
    "save_interval": 1,
    "ntps": 1,
}


def dryrun_multichip(n_devices: int, devices: Sequence | None = None,
                     backend: str | None = None) -> dict:
    """The reference's multi-chip dry run over ``n_devices`` devices:
    ``devices`` default to ``cuda:0 .. cuda:n-1``; it may repeat a card
    (then pass ``backend="gloo"``) or list the CPU. Returns the loss, the
    forward's shape and the runner's positions/s; raises on a non-finite
    loss or forward, or a position without profile rows."""
    import copy

    from aliby_tpu_torch.engine.core import profile_columns
    from aliby_tpu_torch.parallel.pipeline_mesh import run_positions_mesh_states

    n = int(n_devices)
    if devices is None:
        devices = [f"cuda:{i}" for i in range(n)]
    devices = [resolve_device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices given for n_devices={n}")
    if backend is None:
        backend = "gloo" if all(d.type == "cpu" for d in devices) else "nccl"
    sp = 2 if n % 2 == 0 else 1
    dp = n // sp
    B = max(dp, 2) * 2
    feats = (8, 16, 32)
    ranks = spawn_ranks([
        {"name": "train", "kind": "train",
         "args": {"feats": feats, "size": 32, "batch": B, "steps": 1}},
        {"name": "infer", "kind": "forward",
         "args": {"feats": feats, "size": 32, "batch": B, "images": "zeros"}},
    ], devices, dp, sp, backend)
    loss = ranks[0]["train"]["metrics"][0]["loss"]
    if not math.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    pred = assemble([r["infer"] for r in ranks], B, 32)
    if not torch.isfinite(pred).all():
        raise AssertionError("non-finite sharded forward")

    mesh = make_mesh(n, sp=sp, devices=devices)
    n_pos = max(n, 2)
    with tempfile.TemporaryDirectory(prefix="mesh_dryrun_") as tmp:
        root = Path(tmp)
        positions = _positions(root, n_pos)
        t0 = time.perf_counter()
        entries, _ = run_positions_mesh_states(copy.deepcopy(DRYRUN_PIPELINE), positions,
                                               root / "out", capture_order="TCZYX", mesh=mesh,
                                               overwrite=True)
        dt = time.perf_counter() - t0
    rows = {e["pos"]["key"]: len(next(iter(profile_columns(e["state"], e["pipeline"]).values()),
                                      ()))
            for e in entries}
    if len(rows) != n_pos or min(rows.values()) == 0:
        raise AssertionError(f"positions without profile rows: {rows}")
    print(f"dryrun_multichip pipeline: {n_pos} positions in {dt:.2f}s over {dp} dp devices "
          f"({n_pos / dt:.2f} pos/s)")
    print(f"dryrun_multichip({n}): mesh dp={dp} sp={sp} backend={backend} loss={loss:.4f} "
          f"infer={tuple(pred.shape)}")
    return {"loss": loss, "infer_shape": tuple(pred.shape), "positions_per_s": n_pos / dt,
            "dp": dp, "sp": sp, "backend": backend}
