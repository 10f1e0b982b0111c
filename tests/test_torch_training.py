"""Port parity: training (``aliby_tpu_torch.models.training``), ``init_params``
and the f16 checkpoint writer against the JAX package, on the CPU, at widths
(8, 16, 32) and 48x48 or 64x64, in f32 on both sides.

Tolerances (from CPU readings; each reading is the worst seen):
- loss, flow_loss and prob_loss: rtol ``LOSS_RTOL`` 1e-4 (read 8.3e-6;
  the convolution sums run in another order).
- gradients, per tensor, by ``extract.tolerances.gradient_excess``: max
  |g - g_jax| <= 1e-4 of the tensor's largest |g_jax| (read 1.4e-5). Four
  bias tensors are the exception: the conv0 bias of a block with 8
  features feeds a GroupNorm of one channel a group, which removes it, so
  its true gradient is 0 and both frameworks give rounding noise (|g_jax|
  <= 2e-6); there |diff| <= 1e-6 of the model's largest |g_jax| (read
  1.8e-7).
- the optimizer against ``optax.adamw(cosine_decay_schedule(...))`` on one
  gradient sequence, 5 steps: |p - p_optax| <= 4 ulp(max(|p_0|, |p|)) +
  2e-5 sum_s lr_s (read: 0.54 of the bound at the worst element). The
  first term is the f32 rounding of a parameter (torch decays
  ``p (1 - lr wd)`` before the Adam step, optax adds ``wd p`` to the
  update: each rounds once at the parameter's ulp); the second is optax's
  own f32 bias correction: ``1 - 0.999^t`` with 0.999 rounded to f32 is
  1.29e-5 too small at every t, so optax's update is 6.4e-6 of itself too
  large (torch's correction is float64). The schedule: within 3e-7 of
  optax's f32 values.
- three whole f32 train steps (``optax.adamw(1e-3)``): the loss of each
  within rtol 1e-4 of JAX's (read 8.3e-6, flat over the steps).
- resuming from the bundled weights at full width, f32, batch 2 at 128^2,
  ``scripts/train_flagship.py``'s resume schedule (peak 5e-4): Adam's first
  step moves every weight by about the peak rate and the loss jumps ~600x
  in both frameworks; each step's loss within rtol 1e-3 of JAX's through
  the jump (read 5.5e-5; the jump 623x).
- ``synthetic_batch``: images and ``fg`` bit-equal, the generators' next
  draws equal; flows by ``tests/test_torch_flows.py``'s ``masks_to_flows``
  rule (the division by 9 differs, ROADMAP queue 3).
- ``save_params``: the bytes of the JAX package's ``save_params``.
- ``init_params``: Flax's names and shapes; each kernel's std within
  3 / sqrt(n) (relative, n its size; 5 standard errors of a truncated
  normal's std) of lecun_normal's sqrt(1 / fan_in), no value beyond its
  +-2 sigma truncation; the bits follow the seed (Flax's draws are not
  reproduced, ROADMAP queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aliby_tpu.models import training as JT
from aliby_tpu.models.unet import CellposeNet as FlaxNet
from aliby_tpu_torch.extract.tolerances import LOSS_RTOL, gradient_excess
from aliby_tpu_torch.models import flows as TF
from aliby_tpu_torch.models import training as PT
from aliby_tpu_torch.models.segment import CellposeTorch, dispatch_segmenter
from aliby_tpu_torch.models.unet import CellposeNet, init_params
from aliby_tpu_torch.models.weights import (
    BUNDLED_WEIGHTS,
    flax_from_params,
    params_from_flax,
)
from aliby_tpu_torch.test_data import render_cells

torch.set_num_threads(1)

FEATS = (8, 16, 32)
SIZE = 48


def _t(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture(scope="module")
def flax_model():
    model = FlaxNet(base_features=FEATS, dtype=jnp.float32)
    params = jax.jit(model.init)(jax.random.PRNGKey(1), jnp.zeros((1, SIZE, SIZE, 2)))
    return model, jax.tree_util.tree_map(np.asarray, params)


def _port(params) -> CellposeNet:
    model = CellposeNet(base_features=FEATS, dtype=torch.float32)
    model.load_state_dict(params_from_flax(params))
    return model


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(0)
    return [JT.synthetic_batch(rng, 2, SIZE) for _ in range(3)]


@pytest.fixture(scope="module")
def jax_grads(flax_model, batches):
    model, params = flax_model
    fn = jax.jit(jax.value_and_grad(JT.loss_fn, has_aux=True), static_argnums=1)
    (_, metrics), grads = fn(params, model, batches[0])
    return ({k: float(v) for k, v in metrics.items()},
            params_from_flax(jax.tree_util.tree_map(np.asarray, grads)))


@pytest.fixture(scope="module")
def port_grads(flax_model, batches):
    model = _port(flax_model[1])
    loss, metrics = PT.loss_fn(model, _t(batches[0]))
    loss.backward()
    return ({k: float(v) for k, v in metrics.items()},
            {n: p.grad.clone() for n, p in model.named_parameters()})


def test_loss_matches_jax(jax_grads, port_grads):
    want, got = jax_grads[0], port_grads[0]
    assert set(got) == {"loss", "flow_loss", "prob_loss"}
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=k)


def test_gradients_match_jax(jax_grads, port_grads):
    excess = gradient_excess({k: v.numpy() for k, v in port_grads[1].items()},
                             {k: v.numpy() for k, v in jax_grads[1].items()})
    beyond = {k: r for k, (r, _) in excess.items() if r > 1}
    assert not beyond, beyond
    # the conv0 biases of the 8-feature blocks, which GroupNorm removes
    assert sorted(k for k, (_, floor) in excess.items() if floor) == [
        "down.0.0.conv0.bias", "down.0.1.conv0.bias", "up.0.0.conv0.bias", "up.0.1.conv0.bias"]


def test_adamw_and_cosine_schedule_match_optax():
    rng = np.random.default_rng(3)
    shapes = [(3, 3, 8, 16), (16,), (32, 8)]
    p0 = [rng.normal(0, 0.1, s).astype(np.float32) for s in shapes]
    # gradients over six decades, so eps and the decay both matter
    grads = [[(rng.normal(0, 1, s) * rng.choice([1e-6, 1e-2, 1.0], s)).astype(np.float32)
              for s in shapes] for _ in range(5)]
    sched = optax.cosine_decay_schedule(1e-3, 4, 0.05)
    tx = optax.adamw(sched)
    state = tx.init(p0)
    want = p0
    params = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    schedule = PT.cosine_decay_schedule(1e-3, 4, 0.05)
    opt, scheduler = PT.adamw(params, schedule)
    lr_sum = 0.0
    for t in range(5):  # t = 4 is past decay_steps: the schedule holds alpha
        assert opt.param_groups[0]["lr"] == schedule(t)
        np.testing.assert_allclose(schedule(t), float(sched(t)), rtol=3e-7)  # optax: f32
        lr_sum += schedule(t)
        updates, state = tx.update(grads[t], state, want)
        want = optax.apply_updates(want, updates)
        for p, g in zip(params, grads[t]):
            p.grad = torch.from_numpy(g)
        opt.step()
        scheduler.step()
        for p, w, a in zip(params, want, p0):
            got, w = p.detach().numpy().astype(np.float64), np.asarray(w, np.float64)
            ulp = np.spacing(np.maximum(np.abs(a), np.abs(w)).astype(np.float32))
            bound = 4 * ulp.astype(np.float64) + 2e-5 * lr_sum
            assert (np.abs(got - w) <= bound).all(), (t, np.abs(got - w).max())
    assert schedule(4) == schedule(40) == pytest.approx(0.05e-3)


def test_adamw_follows_optax_through_fresh_spikes():
    """The optimizer under the loss spikes of a fresh run at peak 2e-3
    (``scripts/torch_train_parity.py --fresh``): the full-width JAX model
    from a fresh ``lecun_normal`` draw (the port's ``init_params(0)``) at
    32^2, batch 2, 12 steps, one gradient sequence from the JAX loss fed to
    optax's AdamW and to the port's. The loss jumps ~200x within 4 steps (read 11.8 -> 1287 -> 86.7
    -> 2488). Each weight within (t ulp(max(|p_0|, |p_t|)) + 2e-5 of its
    total movement) of optax's after step t (read: 0.76 of that at the
    worst element): each step rounds the weight once in each framework, and
    optax's f32 bias correction makes its update 6.4e-6 of itself too
    large (above)."""
    steps, peak = 12, 2e-3
    model = FlaxNet(dtype=jnp.float32)
    params = jax.tree_util.tree_map(jnp.asarray, flax_from_params(
        init_params(0, in_channels=2, device="cpu", dtype=torch.float32).state_dict()))
    tx = optax.adamw(optax.cosine_decay_schedule(peak, steps, 0.05))
    state = tx.init(params)

    def numpy_tree(tree):
        return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)

    start = {k: v.numpy().astype(np.float64)
             for k, v in params_from_flax(numpy_tree(params)).items()}
    port = {k: torch.nn.Parameter(torch.from_numpy(v.astype(np.float32)))
            for k, v in start.items()}
    opt, scheduler = PT.adamw(port.values(), PT.cosine_decay_schedule(peak, steps, 0.05))
    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: JT.loss_fn(p, model, b), has_aux=True))
    rng = np.random.default_rng(0)
    losses, prev, moved = [], start, dict.fromkeys(start, 0.0)
    for t in range(steps):
        (loss, _), grads = grad_fn(params, JT.synthetic_batch(rng, 2, 32))
        losses.append(float(loss))
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        for k, g in params_from_flax(numpy_tree(grads)).items():
            port[k].grad = g
        opt.step()
        scheduler.step()
        want = {k: v.numpy().astype(np.float64)
                for k, v in params_from_flax(numpy_tree(params)).items()}
        for k, w in want.items():
            moved[k] = moved[k] + np.abs(w - prev[k])
            ulp = np.spacing(np.maximum(np.abs(start[k]), np.abs(w)).astype(np.float32))
            bound = (t + 1) * ulp.astype(np.float64) + 2e-5 * moved[k]
            got = port[k].detach().numpy().astype(np.float64)
            assert (np.abs(got - w) <= bound).all(), (t, k, (np.abs(got - w) / bound).max())
        prev = want
    assert max(losses) > 100 * losses[0], losses


def test_resumed_full_width_f32_trajectory_matches_jax():
    template = FlaxNet(dtype=jnp.float32)
    params = jax.jit(template.init)(jax.random.PRNGKey(0), jnp.zeros((1, 128, 128, 2)))
    params = JT.load_params(BUNDLED_WEIGHTS, params)
    tx = optax.adamw(optax.cosine_decay_schedule(5e-4, 4, 0.05))
    state, step_j = tx.init(params), JT.make_train_step(template, tx)
    port = CellposeNet(dtype=torch.float32)
    port.load_state_dict(PT.load_params(BUNDLED_WEIGHTS, port))
    opt, scheduler = PT.adamw(port.parameters(), PT.cosine_decay_schedule(5e-4, 4, 0.05))
    step_p = PT.make_train_step(port, opt, scheduler)
    rng = np.random.default_rng(1)
    losses = []
    for _ in range(3):
        batch = JT.synthetic_batch(rng, 2, 128)
        params, state, want = step_j(params, state, batch)
        got = step_p(_t(batch))
        losses.append((float(got["loss"]), float(want["loss"])))
    assert losses[1][1] > 100 * losses[0][1]  # the jump of a fresh Adam on warm weights
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=1e-3)


def test_adamw_has_optax_defaults():
    opt, _ = PT.adamw([torch.nn.Parameter(torch.zeros(2))], 1e-3)
    group = opt.param_groups[0]
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    assert group["weight_decay"] == 1e-4 and group["lr"] == 1e-3


def test_three_f32_steps_match_jax(flax_model, batches):
    model, params = flax_model
    step_j = JT.make_train_step(model, optax.adamw(1e-3))
    opt_state = optax.adamw(1e-3).init(params)
    port = _port(params)
    opt, scheduler = PT.adamw(port.parameters(), 1e-3)
    step_p = PT.make_train_step(port, opt, scheduler)
    for i, batch in enumerate(batches):
        params, opt_state, want = step_j(params, opt_state, batch)
        got = step_p(_t(batch))
        for k in ("loss", "flow_loss", "prob_loss"):
            assert got[k].requires_grad is False
            np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL,
                                       err_msg=f"step {i}: {k}")
    assert all(p.grad is None for p in port.parameters())  # zero_grad(set_to_none=True)


@pytest.mark.parametrize("mix", [{}, {"budding_frac": 0.5}, {"nuclei_frac": 0.5}],
                         ids=["plain", "budding", "nuclei"])
def test_synthetic_batch_matches_jax(mix):
    rng_j, rng_p = np.random.default_rng(11), np.random.default_rng(11)
    want = JT.synthetic_batch(rng_j, 4, 64, **mix)
    got = PT.synthetic_batch(rng_p, 4, 64, device="cpu", **mix)
    assert got["image"].dtype == torch.float32 and got["fg"].dtype == torch.bool
    np.testing.assert_array_equal(got["image"].numpy(), want["image"])
    np.testing.assert_array_equal(got["fg"].numpy(), want["fg"])
    assert rng_p.random() == rng_j.random()  # the same draws, in the same order
    flows = got["flows"].numpy()
    assert flows.shape == want["flows"].shape == (4, 2, 64, 64)
    for f, w, fg in zip(flows, want["flows"], want["fg"]):
        far = (np.abs(f - w).max(axis=0) > 1e-3) & fg
        assert far.sum() <= 1e-3 * fg.sum(), (far.sum(), fg.sum())
        assert (f[:, ~fg] == 0).all()
        assert ((f - w) ** 2).sum(axis=0)[fg].mean() < 0.05


def test_batched_flows_are_each_images_own():
    """One masks_to_flows call a batch gives each image the bits it has
    alone, so the batch's targets do not depend on its other images."""
    rng = np.random.default_rng(5)
    labels = [PT._render(rng, 64, 0.3, 0.3)[2] for _ in range(6)]
    lab = torch.from_numpy(np.stack(labels).astype(np.int32))
    batched = TF.masks_to_flows(lab)
    for i in range(len(labels)):
        assert torch.equal(batched[i], TF.masks_to_flows(lab[i:i + 1])[0]), i
    got = PT.synthetic_batch(np.random.default_rng(5), 6, 64, budding_frac=0.3,
                             nuclei_frac=0.3, device="cpu")
    assert torch.equal(got["flows"], batched)


def test_train_step_reduces_loss():
    """The counterpart of tests/test_models.py::test_train_step_reduces_loss."""
    rng = np.random.default_rng(0)
    model = init_params(1, in_channels=2, size=SIZE, device="cpu", base_features=FEATS)
    opt, scheduler = PT.adamw(model.parameters(), 1e-3, weight_decay=0.0)  # optax.adam
    step = PT.make_train_step(model, opt, scheduler)
    batch = PT.synthetic_batch(rng, 2, SIZE, device="cpu")
    loss0 = float(PT.loss_fn(model, batch)[1]["loss"])
    for _ in range(5):
        metrics = step(batch)
    assert float(metrics["loss"]) < loss0


def test_train_synthetic_returns_a_trained_module(capsys):
    model = PT.train_synthetic(n_steps=2, batch=2, size=SIZE, seed=0, log_every=1,
                               model_kwargs={"base_features": FEATS}, device="cpu")
    assert isinstance(model, CellposeNet) and model.dtype == torch.bfloat16
    assert capsys.readouterr().out.count("loss=") == 2
    # the sharded step runs in a process group's mesh (tests/test_torch_sharded_training.py)
    with pytest.raises(ValueError, match="from_process_group"):
        PT.make_sharded_train_step(model, None, None)


def test_training_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = (lambda: init_params(0), lambda: PT.train_synthetic(n_steps=1),
             lambda: PT.synthetic_batch(np.random.default_rng(0), 1, 64))
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# -- checkpoints -----------------------------------------------------------


def test_save_params_bytes_are_jax_bytes(flax_model, tmp_path):
    params = flax_model[1]
    JT.save_params(params, tmp_path / "jax.msgpack")
    PT.save_params(_port(params), tmp_path / "port.msgpack")
    assert (tmp_path / "port.msgpack").read_bytes() == (tmp_path / "jax.msgpack").read_bytes()


def test_msgpack_writer_is_flax_to_bytes():
    from flax import serialization

    from aliby_tpu_torch.models.weights import msgpack_restore, msgpack_serialize

    rng = np.random.default_rng(0)
    tree = {"p" * 40: {"f32": rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
                       "i64": np.arange(70000, dtype=np.int64).reshape(7, -1),  # ext 32
                       "bool6": np.ones(6, bool),  # a payload of 16 bytes: fixext 16
                       "scalar": np.asarray(2.5, np.float16), "empty": np.zeros((0, 3), np.uint8)},
            **{f"k{i}": {"bias": np.full(i + 1, i, np.int32)} for i in range(20)}}  # map 16
    data = msgpack_serialize(tree)
    assert data == serialization.to_bytes(tree)
    back = msgpack_restore(data)
    for (pa, a), (pb, b) in zip(_paths(tree), _paths(back)):
        assert pa == pb and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(TypeError):
        msgpack_serialize({"x": 1.5})


def test_checkpoints_cross_read(flax_model, tmp_path):
    params = flax_model[1]
    rounded = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float16).astype(np.float32),
                                     params)
    PT.save_params(_port(params), tmp_path / "port.msgpack")
    back = JT.load_params(tmp_path / "port.msgpack", params)  # JAX reads the port's file
    for (pa, a), (pb, b) in zip(_paths(rounded), _paths(jax.tree_util.tree_map(np.asarray,
                                                                               back))):
        assert pa == pb and b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    JT.save_params(params, tmp_path / "jax.msgpack")
    state = PT.load_params(tmp_path / "jax.msgpack", _port(params))  # the port reads JAX's
    want = params_from_flax(rounded)
    assert set(state) == set(want)
    for k in want:
        assert state[k].dtype == torch.float32 and torch.equal(state[k], want[k]), k
    with pytest.raises(ValueError, match="template"):
        PT.load_params(tmp_path / "jax.msgpack", CellposeNet())


def test_bundled_checkpoint_round_trips(tmp_path):
    model = CellposeNet()
    model.load_state_dict(PT.load_params(BUNDLED_WEIGHTS, model))
    PT.save_params(model, tmp_path / "again.msgpack")
    assert (tmp_path / "again.msgpack").read_bytes() == BUNDLED_WEIGHTS.read_bytes()


def test_port_checkpoint_segments_as_the_parameters_in_memory(tmp_path):
    """A file the port writes, through dispatch_segmenter, gives the labels
    of the same (f16-rounded) parameters held in memory."""
    state = PT.load_params(BUNDLED_WEIGHTS)
    gen = torch.Generator().manual_seed(0)
    state = {k: v + 1e-2 * v.std() * torch.randn(v.shape, generator=gen) if v.numel() > 1
             else v for k, v in state.items()}  # another trained model, as it were
    path = tmp_path / "perturbed.msgpack"
    PT.save_params(state, path)
    rng = np.random.default_rng(77)
    cells, nuclei, _ = render_cells(96, 8, rng)
    noise = rng.normal(0, 0.03, cells.shape).astype(np.float32)
    pixels = np.stack([cells + noise, nuclei + noise])[None][:, :, None]
    seg = dispatch_segmenter("cellpose", 0, second_channel=1, pretrained_path=str(path),
                             device="cpu")
    got = seg(pixels)[0]
    engine = CellposeTorch(device="cpu")
    engine.model.load_state_dict({k: v.to(torch.float16).to(torch.float32)
                                  for k, v in state.items()})
    want = engine.segment_tiles(np.stack([cells + noise, nuclei + noise])[None])[0]
    assert want.max() > 0
    np.testing.assert_array_equal(got, want)


# -- init_params -----------------------------------------------------------


def test_init_params_follows_flax(flax_model):
    before = torch.get_rng_state()
    model = init_params(0, in_channels=2, size=SIZE, device="cpu", base_features=FEATS)
    assert torch.equal(torch.get_rng_state(), before)  # the caller's RNG untouched
    again = init_params(0, in_channels=2, device="cpu", base_features=FEATS)
    other = init_params(1, in_channels=2, device="cpu", base_features=FEATS)
    state = model.state_dict()
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in state.items())
    assert not torch.equal(state["stem.weight"], other.state_dict()["stem.weight"])
    created = []

    def init(key, x):  # the tree in the order Flax creates it (jit's output is sorted)
        params = flax_model[0].init(key, x)
        created.extend((p, a.shape) for p, a in _paths(params))
        return params

    jax.eval_shape(init, jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 2)))
    ours = list(_paths(flax_from_params(state)))
    assert [(p, a.shape) for p, a in ours] == created
    flax = dict(_paths(flax_model[1]))
    for path, a in ours:
        f = flax[path]
        if path[-1] == "kernel":
            fan_in = int(np.prod(a.shape[:-1]))
            std = np.sqrt(1.0 / fan_in)
            band = 3.0 / np.sqrt(a.size)
            for draws in (a, f):  # the port's and Flax's, by the same rule
                assert abs(draws.std() / std - 1) <= band, (path, draws.std(), std)
                assert np.abs(draws).max() <= 2 * std / 0.87962566103423978 * (1 + 1e-6)
        elif path[-1] == "scale":
            assert (a == 1).all()
        else:
            assert (a == 0).all(), path
