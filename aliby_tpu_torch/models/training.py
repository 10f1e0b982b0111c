"""Training for the flagship segmentation net (counterpart of
``aliby_tpu/models/training.py``).

The loss follows cellpose: a foreground-weighted MSE on 5x-scaled flow
targets plus the binary cross-entropy of the cell logit. Targets come from
:func:`aliby_tpu_torch.models.flows.masks_to_flows` on label maps, one
batched call a batch, so on the card the batch's targets take one
``diffuse_heat`` kernel call.

The optimizer is optax's AdamW as ``torch.optim.AdamW`` with optax's
defaults (:func:`adamw`); the learning rate follows a schedule of the step
count read before the increment, as optax reads it. PyTorch applies the
decoupled weight decay as ``p <- p (1 - lr wd)`` before the Adam step,
optax adds ``wd p`` to the update: the same arithmetic up to rounding.

On the card a step runs with cuDNN deterministic and its autotuner off
(:data:`deterministic_cudnn`), and an f32 model with cuDNN's TF32 off
(``cpnet.tf32_off``), so that two runs from one seed give the same bits
and f32 is f32 as on the CPU. Checkpoints are the JAX package's f16 Flax
msgpack bytes (:func:`save_params`, :func:`load_params`).

:func:`make_sharded_train_step` is the multi-device step over a ``(dp,
sp)`` mesh of ``torch.distributed`` ranks
(:meth:`~aliby_tpu_torch.parallel.mesh.Mesh.from_process_group`): the batch
over dp, image rows over sp (the U-Net's halo exchanges,
:mod:`aliby_tpu_torch.parallel.spatial`), the model and the optimizer
replicated. Each rank's loss is its partial of the global loss, the ranks'
gradients are summed by one all-reduce, and every rank takes the same
AdamW step, so the parameters stay the same bits on every rank. The sums
run in another order than in one process: the step is held to the f32
rules of the one-process step, not to its bits.
"""

from __future__ import annotations

import math
from contextlib import ExitStack
from pathlib import Path
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from aliby_tpu_torch.device import HeldFlags, resolve_device
from aliby_tpu_torch.models import flows as flows_mod
from aliby_tpu_torch.models.cpnet import tf32_off
from aliby_tpu_torch.models.unet import CellposeNet, init_params
from aliby_tpu_torch.models.weights import (
    flax_from_params,
    msgpack_restore,
    msgpack_serialize,
    params_from_flax,
)
from aliby_tpu_torch.test_data import render_budding_movie, render_cells

# cuDNN's deterministic algorithms on and its autotuner off while any
# thread trains (the backward-weight convolutions are not deterministic by
# default; XLA's step is)
deterministic_cudnn = HeldFlags(torch.backends.cudnn, deterministic=True, benchmark=False)


METRICS = ("loss", "flow_loss", "prob_loss")
# the training batch's partition specs over a (dp, sp) mesh, the JAX
# package's make_sharded_train_step's
BATCH_SPEC = {"image": ("dp", "sp", None, None), "flows": ("dp", None, "sp", None),
              "fg": ("dp", "sp", None)}


def loss_fn(model: CellposeNet, batch: dict, reduce: Callable | None = None,
            sp=None) -> tuple[torch.Tensor, dict]:
    """Loss of one batch (``training.py`` ``loss_fn``): ``image`` (B, H, W,
    C) f32, ``flows`` (B, 2, H, W) f32 targets, ``fg`` (B, H, W) bool. Returns
    the loss and a dict of tensors (no host synchronisation).

    With ``reduce`` (a function that sums a tensor over the ranks) ``batch``
    is one rank's block of a global batch, the U-Net runs with ``sp`` (this
    rank's :class:`~aliby_tpu_torch.parallel.spatial.SpatialShard`, or None
    when rows are not split), and the loss and metrics are this rank's
    partials (:func:`loss_from_pred`): their sum over the ranks is the
    global batch's."""
    pred = model(batch["image"]) if sp is None else model(batch["image"], sp=sp)
    return loss_from_pred(pred, batch, reduce)


def loss_from_pred(pred: torch.Tensor, batch: dict,
                   reduce: Callable | None = None) -> tuple[torch.Tensor, dict]:
    """The loss of predictions ``pred`` (B, H, W, 3) against ``batch``'s
    targets. With ``reduce`` it is this block's partial of the global loss:
    the weights ``w`` are normalised by their global mean (``reduce`` sums
    this block's sum of ``w`` and its pixel count over the ranks; ``w`` is
    data, so no gradient flows through it) and every sum is divided by the
    global element count."""
    if reduce is not None:
        return _partial_loss(pred, batch, reduce)
    flow_pred = pred[..., :2]
    logit = pred[..., 2]
    flow_target = 5.0 * torch.movedim(batch["flows"], 1, -1)
    # foreground-weighted flow MSE: fg 5x the background, normalised so the
    # magnitude stays that of the unweighted loss
    fg = batch["fg"].to(torch.float32)
    w = 0.2 + 0.8 * fg[..., None]
    w = w / torch.mean(w)
    flow_loss = torch.mean(w * (flow_pred - flow_target) ** 2)
    # optax.sigmoid_binary_cross_entropy as optax 0.2.6 writes it
    bce = -fg * F.logsigmoid(logit) - (1.0 - fg) * F.logsigmoid(-logit)
    prob_loss = torch.mean(bce)
    loss = 0.5 * flow_loss + prob_loss
    return loss, {"loss": loss.detach(), "flow_loss": flow_loss.detach(),
                  "prob_loss": prob_loss.detach()}


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    """optax's ``cosine_decay_schedule``: step t -> init ((1 - alpha) 0.5
    (1 + cos(pi min(t, T) / T)) + alpha)."""
    if decay_steps <= 0:
        raise ValueError("decay_steps must be positive")

    def schedule(count: int) -> float:
        t = min(count, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
        return init_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def adamw(params, lr: float | Callable[[int], float], b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4):
    """``optax.adamw(lr)`` with optax's defaults (torch's AdamW defaults to
    weight decay 1e-2): ``(optimizer, scheduler)``. ``lr`` is a float or a
    schedule of the step count; the scheduler sets step t's rate to
    ``lr(t)`` exactly (a base rate of 1 times the schedule), t counted
    before the increment: the first step takes ``lr(0)``."""
    schedule = lr if callable(lr) else (lambda count: lr)
    optimizer = torch.optim.AdamW(params, lr=1.0, betas=(b1, b2), eps=eps,
                                  weight_decay=weight_decay)
    return optimizer, torch.optim.lr_scheduler.LambdaLR(optimizer, schedule)


def make_train_step(model: CellposeNet, optimizer: torch.optim.Optimizer,
                    scheduler=None) -> Callable[[dict], dict]:
    """``step(batch) -> metrics``: forward, loss, backward, the optimizer's
    step (and the scheduler's), ``zero_grad(set_to_none=True)``. Once the
    batch is on the device it makes no host synchronisation: the metrics
    are device tensors."""

    def step(batch: dict) -> dict:
        with ExitStack() as stack:
            if batch["image"].is_cuda:
                stack.enter_context(deterministic_cudnn())
                if model.dtype == torch.float32:
                    stack.enter_context(tf32_off())
            loss, metrics = loss_fn(model, batch)
            loss.backward()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        optimizer.zero_grad(set_to_none=True)
        return metrics

    return step


def _partial_loss(pred: torch.Tensor, batch: dict, reduce: Callable):
    flow_target = 5.0 * torch.movedim(batch["flows"], 1, -1)
    fg = batch["fg"].to(torch.float32)
    w = 0.2 + 0.8 * fg[..., None]
    with torch.no_grad():
        stats = reduce(torch.stack([w.sum(dtype=torch.float64),
                                    torch.full((), float(w.numel()), dtype=torch.float64,
                                               device=w.device)]))
        mean_w = (stats[0] / stats[1]).to(torch.float32)
        n = stats[1].to(torch.float32)  # the global batch's pixels
    flow_loss = torch.sum((w / mean_w) * (pred[..., :2] - flow_target) ** 2) / (2.0 * n)
    logit = pred[..., 2]
    bce = -fg * F.logsigmoid(logit) - (1.0 - fg) * F.logsigmoid(-logit)
    prob_loss = torch.sum(bce) / n
    loss = 0.5 * flow_loss + prob_loss
    return loss, {"loss": loss.detach(), "flow_loss": flow_loss.detach(),
                  "prob_loss": prob_loss.detach()}


def make_sharded_train_step(model: CellposeNet, optimizer: torch.optim.Optimizer,
                            scheduler=None, mesh=None):
    """The train step of one rank of a ``(dp, sp)`` mesh
    (:meth:`~aliby_tpu_torch.parallel.mesh.Mesh.from_process_group`):
    ``(step, BATCH_SPEC)``, as the JAX package returns the step and the
    batch's shardings. ``step(batch) -> metrics`` takes the global batch,
    which every rank holds (each renders it from the same seed), and works
    on this rank's block (:data:`BATCH_SPEC`: the batch over dp, rows over
    sp in blocks of :func:`~aliby_tpu_torch.parallel.mesh.sp_rows`).

    Each rank holds the replicated model and optimizer. Its loss is its
    partial of the global loss (:func:`loss_from_pred`); after the backward
    (in which the halo exchanges and GroupNorm's and the style's
    all-reduces route gradients between the sp ranks) one all-reduce sums
    the flattened gradients over all ``dp * sp`` ranks, the metrics'
    partials riding along: a sum, not DDP's mean. Every rank then takes the
    same AdamW step on the same bits. The metrics are the global batch's,
    device tensors; nothing waits on the host but what the backend itself
    waits on (gloo stages CUDA tensors through the host).
    ``step.gradients(batch)`` leaves the global gradient in the
    parameters' ``.grad`` without stepping."""
    import torch.distributed as dist

    from aliby_tpu_torch.parallel.mesh import shard_batch, sp_rows
    from aliby_tpu_torch.parallel.spatial import SpatialShard

    if mesh is None or mesh.rank is None:
        raise ValueError("make_sharded_train_step needs this process's mesh "
                         "(Mesh.from_process_group)")
    _, s = mesh.coords()
    sp = mesh.shape["sp"]
    unit = 2 ** (len(model.feats) - 1)
    params = [p for p in model.parameters() if p.requires_grad]

    def reduce(t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t)
        return t

    def gradients(batch: dict) -> dict:
        """The global batch's gradient in every parameter's ``.grad`` (the
        same bits on every rank) and the global metrics; no optimizer step."""
        block = shard_batch(mesh, batch, spec=BATCH_SPEC, unit=unit)
        shard = (SpatialShard(mesh.sp_group, s, sp_rows(batch["image"].shape[1], sp, unit))
                 if sp > 1 else None)
        with ExitStack() as stack:
            if block["image"].is_cuda:
                stack.enter_context(deterministic_cudnn())
                if model.dtype == torch.float32:
                    stack.enter_context(tf32_off())
            loss, metrics = loss_fn(model, block, reduce=reduce, sp=shard)
            loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads]
                         + [torch.stack([metrics[k] for k in METRICS])])
        dist.all_reduce(flat)
        offset = 0
        for p in params:
            n = p.numel()
            p.grad = flat[offset:offset + n].view_as(p)
            offset += n
        return dict(zip(METRICS, flat[offset:offset + len(METRICS)].unbind(0)))

    def step(batch: dict) -> dict:
        metrics = gradients(batch)
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        optimizer.zero_grad(set_to_none=True)
        return metrics

    step.gradients = gradients
    return step, BATCH_SPEC


def _render(rng: np.random.Generator, size: int, budding_frac: float, nuclei_frac: float):
    """One training field, drawn as ``training.py`` ``synthetic_batch``
    draws it: (ch0, ch1, labels)."""
    draw = rng.random()
    if nuclei_frac and draw < nuclei_frac:
        n = int(rng.integers(6, 16))
        cells, nuclei, _, labels = render_cells(size, n, rng, with_nucleus_labels=True)
        noise = rng.normal(0, 0.03, (size, size)).astype(np.float32)
        ch0 = (nuclei + noise).astype(np.float32)
        ch1 = ((cells - nuclei).clip(0) + noise).astype(np.float32)
    elif budding_frac and draw < nuclei_frac + budding_frac:
        T = int(rng.integers(2, 5))
        frames, labels_t, _ = render_budding_movie(
            size, T, rng, n_mothers=int(rng.integers(4, 9)),
            bud_max_radius=float(rng.uniform(5.0, 8.0)))
        t = int(rng.integers(1, T))  # a frame with buds when possible
        ch0 = frames[t].astype(np.float32)
        labels = labels_t[t]
        ch1 = np.zeros_like(ch0)
    else:
        n = int(rng.integers(6, 16))
        cells, nuclei, labels = render_cells(size, n, rng)
        noise = rng.normal(0, 0.03, (size, size)).astype(np.float32)
        ch0 = (cells + noise).astype(np.float32)
        ch1 = (nuclei + noise).astype(np.float32)
    return ch0, ch1, labels


def synthetic_batch(rng: np.random.Generator, batch: int, size: int, in_channels: int = 2,
                    budding_frac: float = 0.0, nuclei_frac: float = 0.0,
                    device: str | torch.device | None = None) -> dict:
    """(image, flows, fg) training tuples on ``device``, from the same numpy
    draws in the same order as the JAX package's ``synthetic_batch`` (the
    images and ``fg`` are its bits). ``budding_frac`` mixes in budding-yeast
    frames, ``nuclei_frac`` nuclei-as-main frames (main channel the nuclei,
    second the cytoplasm, labels the nuclei). The flows come from one
    batched ``masks_to_flows`` call on ``device``."""
    dev = resolve_device(device)
    imgs, labels = [], []
    for _ in range(batch):
        ch0, ch1, lab = _render(rng, size, budding_frac, nuclei_frac)
        imgs.append(np.stack([ch0, ch1] + [np.zeros_like(ch0)] * (in_channels - 2), -1))
        labels.append(lab)
    lab = torch.from_numpy(np.stack(labels).astype(np.int32)).to(dev)
    return {"image": torch.from_numpy(np.stack(imgs)).to(dev),
            "flows": flows_mod.masks_to_flows(lab),
            "fg": lab > 0}


def train_synthetic(n_steps: int = 200, batch: int = 4, size: int = 128, lr: float = 1e-3,
                    seed: int = 0, model_kwargs: dict | None = None, log_every: int = 50,
                    device: str | torch.device | None = None) -> CellposeNet:
    """Train the flagship on synthetic fields; returns the trained module."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    model = init_params(seed, in_channels=2, size=size, device=dev, **(model_kwargs or {}))
    optimizer, scheduler = adamw(model.parameters(), lr)
    step = make_train_step(model, optimizer, scheduler)
    for i in range(n_steps):
        metrics = step(synthetic_batch(rng, batch, size, device=dev))
        if log_every and (i + 1) % log_every == 0:
            print(f"step {i + 1}: loss={float(metrics['loss']):.4f} "
                  f"flow={float(metrics['flow_loss']):.4f} "
                  f"prob={float(metrics['prob_loss']):.4f}")
    return model


# -- the held-out gate of the training scripts ----------------------------------


HELDOUT_SEED = 987654


def heldout_sets(n_plain: int = 6, n_budding: int = 6, test_data=None,
                 seed: int = HELDOUT_SEED) -> dict:
    """The fixed held-out renders that the JAX package's
    ``scripts/train_flagship.py`` ``heldout_iou`` draws (seed 987654, the
    same draws in the same order; another ``seed`` draws another set the
    same way): set name -> list of ((2, 128, 128) f32 image, ground-truth
    labels). ``test_data`` is a module with ``render_cells`` and
    ``render_budding_movie`` to draw them with (this package's by
    default)."""
    cells_fn, budding_fn = ((render_cells, render_budding_movie) if test_data is None else
                            (test_data.render_cells, test_data.render_budding_movie))
    rng = np.random.default_rng(seed)
    plain = []
    for _ in range(n_plain):
        cells, nuclei, labels = cells_fn(128, int(rng.integers(6, 16)), rng)
        noise = rng.normal(0, 0.03, cells.shape).astype(np.float32)
        plain.append((np.stack([cells + noise, nuclei + noise]), labels))
    budding = []
    for _ in range(n_budding):
        frames, labels_t, _ = budding_fn(128, 3, rng, n_mothers=int(rng.integers(4, 9)))
        img2 = np.stack([frames[-1].astype(np.float32), np.zeros_like(frames[-1], np.float32)])
        budding.append((img2, labels_t[-1]))
    nuclei_set = []
    for _ in range(n_plain):
        cells, nuclei, _, nuc_labels = cells_fn(128, int(rng.integers(6, 16)), rng,
                                                with_nucleus_labels=True)
        noise = rng.normal(0, 0.03, cells.shape).astype(np.float32)
        nuclei_set.append((np.stack([nuclei + noise, (cells - nuclei).clip(0) + noise]),
                           nuc_labels))
    return {"plain": plain, "budding": budding, "nuclei": nuclei_set}


def mean_iou(pred: np.ndarray, gt: np.ndarray) -> float:
    """Mean over the ground truth's objects of the IoU with the predicted
    object that covers most of it (0 where none does)."""
    scores = []
    for lbl in range(1, int(gt.max()) + 1):
        g = gt == lbl
        if not g.any():
            continue
        cand = np.bincount(pred[g].reshape(-1))
        cand[0] = 0
        best = 0.0
        if cand.size > 1 and cand.max() > 0:
            p = pred == int(cand.argmax())
            best = (g & p).sum() / (g | p).sum()
        scores.append(best)
    return float(np.mean(scores)) if scores else 0.0


def heldout_scores(segment_tiles: Callable, sets: dict) -> dict:
    """Each set's mean of :func:`mean_iou` over its images, rounded to 4
    places as the reference rounds it. ``segment_tiles`` maps (N, 2, H, W)
    to N label maps (an engine's ``segment_tiles``) and takes every image
    of every set in one call: ``CellposeTorch`` runs the U-Net in
    micro-batches whose size follows the image size alone, so an image's
    labels do not depend on its batch."""
    images = np.stack([img for items in sets.values() for img, _ in items])
    preds = iter(segment_tiles(images))
    return {name: round(float(np.mean([mean_iou(next(preds), gt) for _, gt in items])), 4)
            for name, items in sets.items()}


# -- checkpoints: f16 Flax msgpack, the JAX package's bytes --------------------


def _sorted_keys(tree):
    """The tree with every dict's keys sorted, as the JAX package's
    ``save_params`` leaves it (``jax.tree_util.tree_map`` rebuilds a dict
    in sorted key order)."""
    if isinstance(tree, dict):
        return {k: _sorted_keys(tree[k]) for k in sorted(tree)}
    return tree


def save_params(model: CellposeNet | dict, path) -> None:
    """Write the parameters (a module or its ``state_dict``) as f16 Flax
    msgpack: the bytes that the JAX package's ``save_params`` writes for the
    same parameters."""
    state = model.state_dict() if isinstance(model, torch.nn.Module) else model
    tree = flax_from_params({k: v.detach().to("cpu", torch.float16) for k, v in state.items()})
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(msgpack_serialize(_sorted_keys(tree)))


def load_params(path, template: CellposeNet | dict | None = None) -> dict[str, torch.Tensor]:
    """Read an f16 (or f32) Flax msgpack checkpoint into an f32 ``state_dict``
    on the CPU (``load_state_dict`` moves it). With ``template`` (a module
    or a ``state_dict``) the checkpoint must hold its names and shapes, as
    ``flax.serialization.from_bytes`` requires of its target."""
    state = params_from_flax(msgpack_restore(Path(path).read_bytes()))
    if template is not None:
        want = template.state_dict() if isinstance(template, torch.nn.Module) else template
        shapes = {k: tuple(v.shape) for k, v in state.items()}
        wanted = {k: tuple(v.shape) for k, v in want.items()}
        if shapes != wanted:
            diff = sorted(set(shapes.items()) ^ set(wanted.items()))[:4]
            raise ValueError(f"checkpoint {path} does not match the template: {diff}")
    return state
