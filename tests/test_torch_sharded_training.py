"""The sharded train step and the sp forward of the port
(``aliby_tpu_torch.models.training.make_sharded_train_step``,
``aliby_tpu_torch.parallel.spatial``) on the CPU: four gloo ranks in
spawned processes (a ``file://`` rendezvous in a temporary directory,
``aliby_tpu_torch.parallel.dryrun.spawn_ranks``) on a (dp, sp) = (2, 2)
mesh, f32, widths (8, 16, 32), a batch of 4 at 32x32, 2 steps of AdamW at
1e-3, against the JAX package's ``make_sharded_train_step`` on
``make_mesh(4, sp=2)`` and the port's one-process ``make_train_step`` from
the same initial parameters and the same numpy draws.

Tolerances, ``tests/test_torch_training.py``'s f32 rules:
- each step's loss, flow_loss and prob_loss within rtol ``LOSS_RTOL``
  (1e-4; read 2.6e-7 against one process): the sharded sums (GroupNorm's,
  the style's, the loss's and the gradients' all-reduces) run in another
  order;
- the first batch's global gradient (the sharded step's ``gradients``,
  before any step) per tensor by ``extract.tolerances.gradient_excess``
  (``GRAD_RTOL`` 1e-4 of the tensor's largest; the four rounding-only
  biases below at their floor) against the one-process gradient, which
  ``tests/test_torch_training.py`` holds to JAX's: this holds the halo
  exchanges' and the all-reduces' backward;
- the parameters after the steps by ``extract.tolerances.update_excess``:
  per tensor, the L2 norm of the difference of the updates ``p - p_0``
  within ``UPDATE_RTOL`` (1e-2) of the reference update's (Adam turns a
  gradient's rounding into an update error of a share of lr where the
  gradient is near its eps; read 1.3e-5 against one process, 4.6e-5
  against JAX's step, which the port's one-process step also reads). The
  four conv0 biases of the 8-feature blocks are
  ``tests/test_torch_training.py``'s exception here as well: GroupNorm
  (one channel a group) removes them, so their true gradient is 0 and both
  runs take Adam steps on rounding noise, in either direction; they are
  held to |p - p_ref| <= 2 sum_s lr_s and do not change the loss;
- the parameters bit-identical on every rank (one all-reduce of the
  gradients, the same AdamW step everywhere).

The sp forward: widths (8, 16, 32, 64) (pooling three times, blocks in
multiples of 8 rows) on two 40x40 fields split 24 + 16 rows, against the
one-process forward at the U-Net's f32 rule (``tests/test_torch_unet.py``:
rtol 1e-4, atol 1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aliby_tpu.models import training as JT
from aliby_tpu.models.unet import CellposeNet as FlaxNet
from aliby_tpu.parallel.mesh import make_mesh as jax_make_mesh
from aliby_tpu_torch.extract.tolerances import LOSS_RTOL, gradient_excess, update_excess
from aliby_tpu_torch.models import training as PT
from aliby_tpu_torch.models.weights import flax_from_params, params_from_flax
from aliby_tpu_torch.parallel import dryrun, spatial
from aliby_tpu_torch.parallel.mesh import sp_rows

torch.set_num_threads(1)

FEATS = (8, 16, 32)
SIZE, BATCH, STEPS, LR = 32, 4, 2, 1e-3
FWD_FEATS, FWD_SIZE = (8, 16, 32, 64), 40
# GroupNorm removes these biases (one channel a group): rounding-noise gradients
REMOVED = {"down.0.0.conv0.bias", "down.0.1.conv0.bias", "up.0.0.conv0.bias",
           "up.0.1.conv0.bias"}


@pytest.fixture(scope="module")
def ranks():
    return dryrun.spawn_ranks([
        {"name": "train", "kind": "train",
         "args": {"feats": FEATS, "size": SIZE, "batch": BATCH, "steps": STEPS, "lr": LR}},
        {"name": "forward", "kind": "forward",
         "args": {"feats": FWD_FEATS, "size": FWD_SIZE, "batch": 2, "seed": 5,
                  "model_seed": 2}},
    ], ["cpu"] * 4, dp=2, sp=2, backend="gloo")


@pytest.fixture(scope="module")
def initial():
    return {k: v.clone() for k, v in
            dryrun.make_model(FEATS, "float32", None, 0, torch.device("cpu")).state_dict().items()}


@pytest.fixture(scope="module")
def one_process(initial):
    model = dryrun.make_model(FEATS, "float32", None, 0, torch.device("cpu"))
    optimizer, scheduler = PT.adamw(model.parameters(), LR)
    grads = []
    optimizer.register_step_pre_hook(lambda *a: grads.append(
        {n: p.grad.detach().clone() for n, p in model.named_parameters()}))
    step = PT.make_train_step(model, optimizer, scheduler)
    rng = np.random.default_rng(0)
    metrics = [{k: float(v) for k, v in step(PT.synthetic_batch(rng, BATCH, SIZE,
                                                                device="cpu")).items()}
               for _ in range(STEPS)]
    return metrics, model.state_dict(), grads[0]


@pytest.fixture(scope="module")
def jax_sharded(initial):
    model = FlaxNet(base_features=FEATS, dtype=jnp.float32)
    params = jax.tree_util.tree_map(jnp.asarray, flax_from_params(initial))
    tx = optax.adamw(LR)
    mesh = jax_make_mesh(4, sp=2)
    step, sharding = JT.make_sharded_train_step(model, tx, mesh)
    opt_state = tx.init(params)
    rng = np.random.default_rng(0)
    metrics = []
    for _ in range(STEPS):
        batch = JT.synthetic_batch(rng, BATCH, SIZE)
        batch = {k: jax.device_put(v, sharding[k]) for k, v in batch.items()}
        params, opt_state, m = step(params, opt_state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, params_from_flax(jax.tree_util.tree_map(np.asarray, params))


def _assert_params_within(got: dict, want: dict, initial: dict) -> None:
    excess = update_excess(got, want, initial, LR * STEPS, noise=REMOVED)
    beyond = {k: r for k, r in excess.items() if r > 1}
    assert not beyond, beyond


def test_parameters_are_the_same_bits_on_every_rank(ranks):
    first = ranks[0]["train"]["params"]
    for r in ranks[1:]:
        assert r["train"]["params"].keys() == first.keys()
        for name, p in r["train"]["params"].items():
            assert torch.equal(p, first[name]), name
        assert r["train"]["metrics"] == ranks[0]["train"]["metrics"]


@pytest.mark.parametrize("ref", ["one_process", "jax_sharded"])
def test_sharded_step_losses(ranks, ref, request):
    want = request.getfixturevalue(ref)[0]
    got = ranks[0]["train"]["metrics"]
    assert len(got) == len(want) == STEPS
    for i, (g, w) in enumerate(zip(got, want)):
        assert set(g) == {"loss", "flow_loss", "prob_loss"}
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=LOSS_RTOL, err_msg=f"step {i}: {k}")
    assert got[1]["loss"] < got[0]["loss"]


@pytest.mark.parametrize("ref", ["one_process", "jax_sharded"])
def test_sharded_step_parameters(ranks, initial, ref, request):
    want = request.getfixturevalue(ref)[1]
    got = ranks[0]["train"]["params"]
    assert got.keys() == want.keys()
    _assert_params_within(got, want, initial)
    moved = [n for n, p in got.items() if not torch.equal(p, initial[n])]
    assert len(moved) == len(got)


def test_sharded_step_first_gradient(ranks, one_process):
    want = one_process[2]
    got = {k: v.numpy() for k, v in ranks[0]["train"]["grads"].items()}
    excess = gradient_excess(got, {k: np.asarray(v) for k, v in want.items()})
    assert not {k: r for k, (r, _) in excess.items() if r > 1}
    assert sorted(k for k, (_, floor) in excess.items() if floor) == sorted(REMOVED)
    for r in ranks[1:]:
        for name, g in r["train"]["grads"].items():
            assert torch.equal(g, ranks[0]["train"]["grads"][name]), name


def test_sp_forward_with_uneven_blocks(ranks):
    assert sp_rows(FWD_SIZE, 2, 8) == (24, 16)
    blocks = [r["forward"] for r in ranks]
    assert sorted((b["batch"], b["rows"]) for b in blocks) == [
        ((0, 1), (0, 24)), ((0, 1), (24, 40)), ((1, 2), (0, 24)), ((1, 2), (24, 40))]
    got = dryrun.assemble(blocks, 2, FWD_SIZE)
    model = dryrun.make_model(FWD_FEATS, "float32", None, 2, torch.device("cpu")).eval()
    with torch.no_grad():
        want = model(torch.from_numpy(dryrun.forward_inputs(2, FWD_SIZE, 5)))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
    assert not torch.equal(got, want)  # the sums ran in another order


@pytest.mark.parametrize("height, sp, unit", [(36, 2, 8), (8, 2, 8), (1084, 2, 8), (5, 6, 1)])
def test_rows_that_cannot_be_split_raise(height, sp, unit):
    with pytest.raises(ValueError, match="multiple of"):
        sp_rows(height, sp, unit)


def test_sp_rows_splits_1080_into_544_and_536():
    assert sp_rows(1080, 2, 8) == (544, 536)
    assert sp_rows(40, 2, 4) == (20, 20)
    assert sp_rows(48, 4, 8) == (16, 16, 8, 8)


def test_forward_refuses_blocks_off_the_pooling_grid():
    model = dryrun.make_model(FWD_FEATS, "float32", None, 0, torch.device("cpu"))
    shard = spatial.SpatialShard(None, 0, (20, 20))  # multiples of 4, not of 8
    with pytest.raises(ValueError, match="multiple of 8"):
        model(torch.zeros(1, 20, 16, 2), sp=shard)
    with pytest.raises(ValueError, match="rows"):
        model(torch.zeros(1, 16, 16, 2), sp=spatial.SpatialShard(None, 0, (24, 16)))


def test_loss_partials_sum_to_the_global_loss():
    """Four blocks (2 images x 2 row blocks) whose foregrounds differ, so
    each block's sum of weights differs from the others': the partials,
    normalised by the global mean weight and count, sum to the global
    loss; the gradients of the predictions too."""
    rng = np.random.default_rng(4)
    batch = PT.synthetic_batch(rng, 2, 32, device="cpu")
    batch["fg"][0, :16] = False  # the first image's upper block: background only
    pred = torch.from_numpy(rng.normal(0, 2, (2, 32, 32, 3)).astype(np.float32))
    pred.requires_grad_(True)
    want, want_m = PT.loss_from_pred(pred, batch)
    want.backward()
    want_grad = pred.grad.clone()
    pred.grad = None

    blocks = [(slice(b, b + 1), slice(r, r + 16)) for b in (0, 1) for r in (0, 16)]

    def part(t, b, r, rows_axis):
        index = [b] + [slice(None)] * (t.dim() - 1)
        index[rows_axis] = r
        return t[tuple(index)]

    def block_batch(b, r):
        return {"image": part(batch["image"], b, r, 1), "flows": part(batch["flows"], b, r, 2),
                "fg": part(batch["fg"], b, r, 1)}

    stats = []
    for b, r in blocks:
        w = 0.2 + 0.8 * block_batch(b, r)["fg"].to(torch.float32)
        stats.append(torch.stack([w.sum(dtype=torch.float64),
                                  torch.tensor(float(w.numel()), dtype=torch.float64)]))
    total = torch.stack(stats).sum(0)
    assert len({float(s[0]) for s in stats}) == 4  # every block's sum of w differs
    losses, metrics = [], []
    for b, r in blocks:
        loss, m = PT.loss_from_pred(part(pred, b, r, 1), block_batch(b, r),
                                    reduce=lambda t: total.clone())
        losses.append(loss)
        metrics.append(m)
    summed = torch.stack(losses).sum()
    summed.backward()
    np.testing.assert_allclose(float(summed.detach()), float(want.detach()), rtol=1e-6)
    for k in ("loss", "flow_loss", "prob_loss"):
        np.testing.assert_allclose(sum(float(m[k]) for m in metrics), float(want_m[k]),
                                   rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(pred.grad.numpy(), want_grad.numpy(), rtol=1e-5, atol=1e-9)


def test_sharded_step_needs_a_process_mesh():
    from aliby_tpu_torch.parallel.mesh import make_mesh

    model = dryrun.make_model(FEATS, "float32", None, 0, torch.device("cpu"))
    opt, sched = PT.adamw(model.parameters(), LR)
    with pytest.raises(ValueError, match="from_process_group"):
        PT.make_sharded_train_step(model, opt, sched, make_mesh(devices=["cpu"] * 2))


def test_dryrun_multichip_on_cpu_ranks(capsys):
    out = dryrun.dryrun_multichip(2, devices=["cpu", "cpu"])
    assert (out["dp"], out["sp"], out["backend"]) == (1, 2, "gloo")
    assert np.isfinite(out["loss"]) and out["infer_shape"] == (4, 32, 32, 3)
    assert "dryrun_multichip(2): mesh dp=1 sp=2" in capsys.readouterr().out
