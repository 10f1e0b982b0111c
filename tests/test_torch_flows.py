"""Port parity: flow dynamics and mask reconstruction
(``aliby_tpu_torch.models.flows``) against ``aliby_tpu.models.flows``, on
the GT-flow fields of ``test_dynamics_parity.py``'s CONFIGS.

Labels are compared bit for bit. ``masks_to_flows`` is not bit-equal:
XLA:CPU multiplies by a rounded 1/9 where the port divides by 9, and its
log1p/sqrt differ from PyTorch's in the last bit; a unit gradient near a
flat spot turns those ulps into a different direction. Stated bound: at
most 0.1% of foreground pixels differ by more than 1e-3, and every
object's mean squared flow difference stays below 0.05 (an eighth of the
0.4 QC threshold).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aliby_tpu.models import flows as FL
from aliby_tpu.ops.labels import relabel_dense as jax_relabel_dense
from aliby_tpu.test_data import render_dense_cells
from aliby_tpu_torch.models import flows as TF
from aliby_tpu_torch.ops import labels as TL
from aliby_tpu_torch.ops.labels import relabel_dense
from fill_cases import FILL_CASES
from test_dynamics_parity import CONFIGS

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))[None]


@pytest.fixture(scope="module", params=CONFIGS, ids=[c[0] for c in CONFIGS])
def gt_field(request):
    _, size, n, rmin, rmax, seed = request.param
    gt = render_dense_cells(size, n, np.random.default_rng(seed), rmin, rmax)
    flows = np.asarray(FL.masks_to_flows(gt))
    cellprob = np.where(gt > 0, 4.0, -4.0).astype(np.float32)
    return gt, flows, cellprob


def test_masks_to_flows(gt_field):
    gt, flows, _ = gt_field
    got = TF.masks_to_flows(_t(gt)).numpy()[0]
    assert got.shape == flows.shape and got.dtype == np.float32
    fg = gt > 0
    far = (np.abs(got - flows).max(axis=0) > 1e-3) & fg
    assert far.sum() <= 1e-3 * fg.sum(), (far.sum(), fg.sum())
    err = ((got - flows) ** 2).sum(axis=0)
    assert max(err[gt == i].mean() for i in range(1, gt.max() + 1)) < 0.05
    assert (got[:, ~fg] == 0).all()


def test_follow_flows_and_sinks(gt_field):
    gt, flows, cellprob = gt_field
    fg = cellprob > 0
    want = np.asarray(FL.follow_flows(jnp.asarray(flows), jnp.asarray(fg)))
    got = TF.follow_flows(_t(flows), _t(fg)).numpy()[0]
    np.testing.assert_array_equal(got, want)
    for drop in (True, False):
        want_l = np.asarray(FL.masks_from_sinks(
            jnp.asarray(want), jnp.asarray(fg), max_labels=512, drop_megamasks=drop))
        got_l = TF.masks_from_sinks(_t(want), _t(fg), max_labels=512,
                                    drop_megamasks=drop).numpy()[0]
        np.testing.assert_array_equal(got_l, want_l)


@pytest.mark.parametrize("n_iter", [0, 1, 4])
def test_follow_flows_other_schedules(n_iter):
    # n_iter > 2 is the ported-checkpoint schedule (true bilinear gathers)
    gt = render_dense_cells(48, 6, np.random.default_rng(4), 4.0, 9.0)
    flows = np.asarray(FL.masks_to_flows(gt))
    fg = gt > 0
    want = np.asarray(FL.follow_flows(jnp.asarray(flows), jnp.asarray(fg), n_iter=n_iter))
    got = TF.follow_flows(_t(flows), _t(fg), n_iter=n_iter).numpy()[0]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("flow_threshold", [0.4, None])
def test_masks_from_flows(gt_field, flow_threshold):
    gt, flows, cellprob = gt_field
    want = np.asarray(FL.masks_from_flows(
        flows, cellprob, max_labels=512, flow_threshold=flow_threshold))
    got = TF.masks_from_flows(_t(flows), _t(cellprob), max_labels=512,
                              flow_threshold=flow_threshold).numpy()[0]
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got.max() >= gt.max() // 2


def test_masks_from_flows_batched_equals_single():
    fields = [render_dense_cells(64, 8, np.random.default_rng(s), 4.0, 9.0) for s in (5, 6)]
    flows = np.stack([np.asarray(FL.masks_to_flows(g)) for g in fields])
    cellprob = np.stack([np.where(g > 0, 4.0, -4.0).astype(np.float32) for g in fields])
    both = TF.masks_from_flows(torch.from_numpy(flows), torch.from_numpy(cellprob),
                               flow_threshold=0.4)
    for i in range(2):
        one = TF.masks_from_flows(torch.from_numpy(flows[i : i + 1]),
                                  torch.from_numpy(cellprob[i : i + 1]), flow_threshold=0.4)
        assert torch.equal(both[i], one[0])


@pytest.mark.parametrize("case", list(FILL_CASES))
def test_fill_label_holes(case):
    labels = FILL_CASES[case]()
    want = np.stack([np.asarray(FL.fill_label_holes(jnp.asarray(x))) for x in labels])
    got = TL.fill_label_holes(torch.from_numpy(labels)).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "annulus_and_u":
        assert got[0, 32, 32] == 1


def test_fill_label_holes_cpu_takes_the_plain_path():
    labels = torch.from_numpy(FILL_CASES["annulus_and_u"]())
    before = TL.fill_label_holes.launches
    got = TL.fill_label_holes(labels)
    assert TL.fill_label_holes.launches == before
    assert torch.equal(got, TL.fill_label_holes_plain(labels))


@pytest.mark.parametrize("shape", [(128, 128), (293, 300)])
def test_label_median_centers_both_paths(shape):
    H, W = shape
    rng = np.random.default_rng(7)
    gt = np.zeros((H, W), np.int32)
    sq = render_dense_cells(min(H, W), 30, rng, 4.0, 12.0)
    gt[: sq.shape[0], : sq.shape[1]] = sq
    gt[H - 6 : H - 1, W - 6 : W - 1] = gt.max() + 1
    want = np.asarray(FL.label_median_centers(gt, max_labels=64))
    got = TF.label_median_centers(_t(gt), max_labels=64).numpy()[0]
    np.testing.assert_array_equal(got, want)


def test_relabel_dense():
    rng = np.random.default_rng(9)
    labels = rng.choice([0, 0, 3, 9, 17, 40], size=(2, 20, 20)).astype(np.int32)
    labels[1][labels[1] == 9] = 0
    got = relabel_dense(torch.from_numpy(labels), 41, 2).numpy()
    for i in range(2):
        want = np.asarray(jax_relabel_dense(jnp.asarray(labels[i]), 41, 2))
        np.testing.assert_array_equal(got[i], want)
