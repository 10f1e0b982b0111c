"""The port's training loop held to the JAX package's, as
``scripts/torch_train_parity.py`` holds them at the training script's
length, here at 5 steps: resumed from the bundled weights at full width, in
f32, on one stream of batches (8 at 128^2, seed 0) that the JAX package's
``synthetic_batch`` renders once for both, on the cosine schedule of 5
steps from 5e-4; then the held-out IoU of both checkpoints (and the bundled
weights) through both engines with their U-Nets in f32 (the script's held
rule), 2 images a set.

Tolerances:
- the first step's loss (both loops at the same parameters): rtol
  ``LOSS_RTOL`` (read 6.0e-5: the full-width f32 forward in another order,
  on a loss that is a small residual);
- the steps after Adam's first step: rtol 1e-3, the rule of
  ``tests/test_torch_training.py``'s resumed trajectory (read up to 1.9e-4:
  Adam's first step moves each weight by about the rate whatever its
  gradient, so a gradient that is rounding noise in both frameworks moves
  its weight apart, and the loss jumps ~1600x; an optimizer written with
  optax's own f32 arithmetic read the same). The port's loop with a
  planted fault on the same batches is refused at step 2: the schedule
  one step late (read 0.18) and Adam's eps 1e-6 (read 9.0e-3; b2 0.99
  reads 7.6e-5 there, 6.2e-3 at step 3).
  Weight decay off or ten times too strong reads as no fault (1.97e-4,
  1.78e-4: 5 steps of 5e-4 x 1e-4 move a weight by 2.5e-7 of itself), so
  the decay is held alone, with zero gradients, against optax;
- each held-out IoU within 0.005 (``scripts/train_flagship.py``'s
  acceptance margin) of the JAX engine's on the JAX checkpoint, and the
  port's engine on the bundled weights within 0.005 of JAX's on them; in
  f32 the two engines give the same labels on the same checkpoint.
"""

import contextlib
import importlib.util
import io
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

from aliby_tpu.models import training as JT
from aliby_tpu_torch.extract.tolerances import LOSS_RTOL
from aliby_tpu_torch.models import training as PT
from aliby_tpu_torch.models.unet import init_params
from aliby_tpu_torch.models.weights import BUNDLED_WEIGHTS

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
STEPS, N_HELDOUT, PORT_THREADS = 5, 2, 4


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_train_parity", ROOT / "scripts" / "torch_train_parity.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


parity = _script()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    # the port's half of this serial chain at full width takes 4 of torch's
    # threads (XLA takes its own): 7.4 s a train step on one
    threads = torch.get_num_threads()
    torch.set_num_threads(PORT_THREADS)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            out = parity.train(0, STEPS, fresh=False)
        root = tmp_path_factory.mktemp("train_parity")
        checkpoints = {"jax": root / "jax.msgpack", "port": root / "port.msgpack",
                       "bundled": BUNDLED_WEIGHTS}
        JT.save_params(out["jax_params"], checkpoints["jax"])
        PT.save_params(out["port_model"], checkpoints["port"])
        out["iou"] = parity.evaluate(checkpoints, parity.heldout_sets(N_HELDOUT),
                                     parity.Engines("f32"))
    finally:
        torch.set_num_threads(threads)
    return out


def test_first_loss_within_loss_rtol(run):
    got, want = run["losses"]["port"][0], run["losses"]["jax"][0]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def _assert_later_losses_match(got, want):
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-3)


def test_losses_through_adams_jump(run):
    got, want = run["losses"]["port"], run["losses"]["jax"]
    assert len(got) == len(want) == STEPS
    assert want[1] > 100 * want[0]  # the jump of a fresh Adam on warm weights
    _assert_later_losses_match(got, want)


SCHEDULE = PT.cosine_decay_schedule(5e-4, STEPS, parity.ALPHA)
PLANTED = {"schedule one step late": {"lr": lambda t: SCHEDULE(t + 1)},
           "adam eps 1e-6": {"eps": 1e-6}}


@pytest.mark.parametrize("fault", sorted(PLANTED))
def test_losses_refuse_a_planted_optimizer_fault(run, fault):
    """The port's loop from the bundled weights on the run's first
    batches (2), with one optimizer fault: the second loss misses rtol
    1e-3."""
    model = init_params(0, in_channels=2, size=128, device="cpu", dtype=torch.float32)
    model.load_state_dict(PT.load_params(BUNDLED_WEIGHTS, model))
    kwargs = dict(PLANTED[fault])
    opt, scheduler = PT.adamw(model.parameters(), kwargs.pop("lr", SCHEDULE), **kwargs)
    step = PT.make_train_step(model, opt, scheduler)
    threads = torch.get_num_threads()
    torch.set_num_threads(PORT_THREADS)
    try:
        got = [float(step({k: torch.from_numpy(np.asarray(v)) for k, v in b.items()})["loss"])
               for b in run["batches"]]
    finally:
        torch.set_num_threads(threads)
    with pytest.raises(AssertionError):
        _assert_later_losses_match(got, run["losses"]["jax"][:2])


PEAK = 0.5


@pytest.mark.parametrize("weight_decay", [1e-4, 0.0])
def test_weight_decay_matches_optax_under_zero_gradients(weight_decay):
    """With zero gradients Adam's step is 0 and the decay alone moves the
    weights: the port's AdamW (optax's decay of 1e-4) against optax's, on
    the cosine schedule of the loop, within 1 ulp a step; with the decay
    planted off the weights do not move, and the check refuses it. The
    rate is large so that the decay moves each weight by many ulp."""
    rng = np.random.default_rng(7)
    p0 = rng.normal(0, 0.3, (64, 32)).astype(np.float32)
    tx = optax.adamw(optax.cosine_decay_schedule(PEAK, STEPS, parity.ALPHA))
    want, state = p0, tx.init(p0)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt, scheduler = PT.adamw([param], PT.cosine_decay_schedule(PEAK, STEPS, parity.ALPHA),
                              weight_decay=weight_decay)
    for _ in range(STEPS):
        updates, state = tx.update(np.zeros_like(p0), state, want)
        want = optax.apply_updates(want, updates)
        param.grad = torch.zeros_like(param)
        opt.step()
        scheduler.step()
    got, want = param.detach().numpy(), np.asarray(want)
    assert np.abs(want - p0).max() > 20 * np.spacing(np.abs(p0)).max()  # the decay moved them
    close = np.abs(got - want) <= STEPS * np.spacing(np.abs(want))
    assert close.all() == (weight_decay == 1e-4), np.abs(got - want).max()


@pytest.mark.parametrize("what", ["port on port", "jax on port", "port on jax",
                                  "port on bundled"])
def test_heldout_iou(run, what):
    ref = "jax on bundled" if what.endswith("bundled") else "jax on jax"
    rule = parity.rule(run["iou"], None)[f"{what} against {ref}"]
    assert rule["ok"], (what, run["iou"][what], run["iou"][ref], rule)


def test_bundled_weights_segment_the_heldout_sets(run):
    """The incumbent scores on every set through both engines (so the rule
    above compares real segmentations there), the same in both."""
    assert min(run["iou"]["jax on bundled"].values()) > 0.8, run["iou"]["jax on bundled"]
    assert run["iou"]["port on bundled"] == run["iou"]["jax on bundled"]


def test_the_rule():
    """``scripts/torch_train_parity.py``'s rule: a gap past 0.005 on one set
    misses it, the chaos floor widens the limit of its own set only."""
    base = {"plain": 0.9, "budding": 0.8, "nuclei": 0.7}
    iou = {"jax on jax": base, "port on port": {**base, "budding": 0.806}}
    assert not parity.rule(iou, None)["port on port against jax on jax"]["ok"]
    assert parity.rule(iou, {"budding": 0.01})["port on port against jax on jax"]["ok"]
    assert not parity.rule(iou, {"plain": 0.01})["port on port against jax on jax"]["ok"]
    iou["port on port"] = {**base, "nuclei": 0.695}
    assert parity.rule(iou, None)["port on port against jax on jax"]["ok"]


def test_port_renders_the_heldout_sets_as_jax():
    sets = parity.heldout_sets(1)  # raises where the port's renders differ
    assert [len(v) for v in sets.values()] == [1, 1, 1]
    img, gt = sets["plain"][0]
    assert img.shape == (2, 128, 128) and img.dtype == np.float32 and gt.max() >= 6
