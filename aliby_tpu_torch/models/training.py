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


def loss_fn(model: CellposeNet, batch: dict) -> tuple[torch.Tensor, dict]:
    """Loss of one batch (``training.py`` ``loss_fn``): ``image`` (B, H, W,
    C) f32, ``flows`` (B, 2, H, W) f32 targets, ``fg`` (B, H, W) bool. Returns
    the loss and a dict of tensors (no host synchronisation)."""
    pred = model(batch["image"])  # (B, H, W, 3)
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


def make_sharded_train_step(*args, **kwargs):
    raise NotImplementedError(
        "the sharded (dp, sp) train step runs on several GPUs: ROADMAP queue 1 item 7")


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
