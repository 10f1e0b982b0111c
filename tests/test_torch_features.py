"""Port parity: the feature families of ``aliby_tpu_torch.extract.features``
against ``aliby_tpu.extract.features`` (JAX on the CPU, ``jax.vmap`` over the
port's batch axis), on one field of separate cells and one of touching
cells, 96x96, max_labels 32.

Tolerance: ``aliby_tpu_torch.extract.tolerances`` (shared with
``chip_smoke.py``): integer-valued features exact; the rest rtol 1e-5
(pearson/slope 1e-4) with atol 1e-6 of the feature's scale, or of the
magnitude of the terms that cancel where a value is formed by
cancellation; costes/costes_2 may differ on at most 5% of the objects (at
least 1), and nowhere else. The differences are XLA:CPU's: it contracts
``a - b*c`` into one fused multiply-add inside its fusions, where the port
rounds the product (as on the card). NaN positions (absent labels) equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aliby_tpu.extract import features as J
from aliby_tpu.test_data import render_cells, render_dense_cells
from aliby_tpu_torch.extract import features as T
from aliby_tpu_torch.extract.tolerances import (
    THRESHOLD_DECIDED,
    THRESHOLD_SHARE,
    beyond_tolerance,
    tolerance,
)

torch.set_num_threads(1)
ML = 32


@pytest.fixture(scope="module")
def field():
    rng = np.random.default_rng(23)
    cells, nuclei, sparse = render_cells(96, 10, rng)
    dense = render_dense_cells(96, 30, rng, 3.0, 8.0)
    labels = np.stack([sparse, dense]).astype(np.int32)
    noise = lambda: rng.normal(0.02, 0.01, (2, 96, 96)).astype(np.float32)  # noqa: E731
    yy, xx = np.mgrid[0:96, 0:96] / 96.0
    wave = (np.sin(9 * xx) * np.cos(7 * yy)) ** 2  # varies inside every touching cell
    im1 = np.stack([nuclei, (dense > 0) * (0.2 + wave)]).astype(np.float32) + noise()
    im2 = np.stack([cells, (dense > 0) * (0.1 + 0.8 * wave[::-1] + 0.05 * (dense % 3))])
    im2 = im2.astype(np.float32) + noise()
    return labels, im1, im2


def check_feature(feat: str, g: np.ndarray, w: np.ndarray, ref) -> None:
    """One feature's port values ``g`` against the reference ``w`` at the
    tolerances of ``tolerances``; ``ref(feature)`` gives the reference
    values of another feature of the same objects."""
    off = beyond_tolerance(feat, g, w, ref)
    if feat in THRESHOLD_DECIDED:
        n_obj = int((~np.isnan(w) | ~np.isnan(g)).sum())
        assert off.sum() <= max(1, THRESHOLD_SHARE * n_obj), f"{feat}: {off.sum()} of {n_obj} differ"
        return
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=feat)
    rtol, atol = tolerance(feat, ref)
    assert not off.any(), (f"{feat}: {int(off.sum())} values beyond rtol {rtol}, atol {atol}: "
                           f"got {g[off]}, want {w[off]}")


def _compare(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k].numpy()
        assert g.shape == w.shape == (2, ML), k
        check_feature(k, g, w, lambda name: np.asarray(want[name]))


def test_sizeshape(field):
    labels = field[0]
    want = jax.vmap(lambda l: J.sizeshape(l, ML))(jnp.asarray(labels))
    got = T.sizeshape(torch.from_numpy(labels), ML)
    assert len(got) == 78
    _compare(got, want)


@pytest.mark.parametrize("edges", [False, True])
def test_intensity(field, edges):
    labels, im1, _ = field
    want = jax.vmap(lambda l, im: J.intensity(l, im, ML, edge_measurements=edges))(
        jnp.asarray(labels), jnp.asarray(im1))
    got = T.intensity(torch.from_numpy(labels), torch.from_numpy(im1), ML,
                      edge_measurements=edges)
    assert len(got) == (21 if edges else 16)
    _compare(got, want)


@pytest.mark.parametrize("name", ["pearson", "manders_fold", "rwc", "costes"])
def test_colocalisation(field, name):
    labels, im1, im2 = field
    fn = J.CORRELATION_FEATURES[name]
    want = jax.vmap(lambda l, a, b: fn(l, a, b, ML))(*map(jnp.asarray, field))
    got = T.CORRELATION_FEATURES[name](*map(torch.from_numpy, field), ML)
    _compare(got, want)


def test_costes_threshold_step_divides(field, monkeypatch):
    """The threshold step ``max(im1) / scale_max`` is an IEEE division in the
    port; XLA:CPU multiplies by the rounded reciprocal of 255. With that
    reciprocal put back, the port's ``costes`` is bit-equal to the JAX
    package's on this field (``costes_2`` still differs on one object: the
    Deming regression's products, contracted differently by XLA:CPU)."""
    m = torch.linspace(0.1, 3.0, 1000)
    step = T._div(m, 255.0)
    np.testing.assert_array_equal(step.numpy(), (m.double() / 255.0).float().numpy())
    assert (step != m * torch.tensor(np.float32(1) / np.float32(255))).any()
    recip = lambda a, b: a * torch.tensor(np.float32(1) / np.float32(b))  # noqa: E731
    monkeypatch.setattr(T, "_div", recip)
    want = jax.vmap(lambda l, a, b: J.costes(l, a, b, ML))(*map(jnp.asarray, field))
    got = T.costes(*map(torch.from_numpy, field), ML)
    np.testing.assert_array_equal(got["costes"].numpy(), np.asarray(want["costes"]))


def test_feret_family(field):
    from aliby_tpu.extract.reductions import directional_extents, feret_diameters

    labels = jnp.asarray(field[0])
    mx, mn = jax.vmap(lambda l: feret_diameters(*directional_extents(l, ML)))(labels)
    got = T.feret(torch.from_numpy(field[0]), ML)
    np.testing.assert_allclose(got["MaxFeretDiameter"].numpy(), np.asarray(mx), rtol=1e-6)
    np.testing.assert_allclose(got["MinFeretDiameter"].numpy(), np.asarray(mn), rtol=1e-6)


def _sizeshape_pair(labels: np.ndarray):
    """(port, JAX) sizeshape of one (H, W) label map, each value of object i
    at [i]."""
    want = {k: np.asarray(v) for k, v in J.sizeshape(jnp.asarray(labels), 8).items()}
    got = {k: v[0].numpy() for k, v in T.sizeshape(torch.from_numpy(labels[None]), 8).items()}
    return got, want


def test_hu_moments_near_zero_are_held_to_their_terms():
    """A Hu moment formed by cancellation: the one cell of a 64^2 Cell
    Painting field (``cellpainting_movie(1, 3, 64, seed=5, n_cells=1)``,
    timepoint 0, channel 3 segmented alone by the bundled U-Net in f32, as
    the runner's mesh segments it) has ``AreaShape_HuMoment_6`` 1.78945e-15
    from terms of 2.5e-11; the port reads 1.78942e-15. That is beyond rtol
    1e-5 and beyond 1e-6 of the column's largest (the value itself), and
    within 1e-6 of the magnitude of its terms."""
    from aliby_tpu_torch.models.segment import CellposeTorch
    from aliby_tpu_torch.test_data import cellpainting_movie

    movie = cellpainting_movie(1, 3, 64, seed=5, n_cells=1)
    image = np.stack([movie[0, 0, 3, 0].astype(np.float32), np.zeros((64, 64), np.float32)])
    engine = CellposeTorch(model_kwargs={"dtype": torch.float32}, device="cpu")
    labels = engine.segment_tiles(image[None])[0].astype(np.int32)
    assert labels.max() == 1
    got, want = _sizeshape_pair(labels)
    g, w = got["AreaShape_HuMoment_6"][0], want["AreaShape_HuMoment_6"][0]
    assert 0 < abs(w) < 1e-14 and abs(g - w) > 1e-5 * abs(w) + 1e-6 * abs(w)
    for k in range(7):
        feat = f"AreaShape_HuMoment_{k}"
        check_feature(feat, got[feat], want[feat], lambda name: want[name])


@pytest.mark.parametrize("k", range(2, 7))
def test_hu_moment_rule_catches_a_relative_error_of_1e_3(field, k):
    """On the objects of the two 96^2 fields whose Hu moment k is of
    ordinary size (at least 1% of its terms), a relative error of 1e-3 is
    beyond the rule on every one."""
    feat = f"AreaShape_HuMoment_{k}"
    want = jax.vmap(lambda l: J.sizeshape(l, ML))(jnp.asarray(field[0]))
    for b in range(2):
        ref = {name: np.asarray(v)[b] for name, v in want.items()}
        w = ref[feat]
        _, atol = tolerance(feat, lambda name: ref[name])
        ordinary = ~np.isnan(w) & (np.abs(w) >= 1e3 * atol)  # terms = 1e6 atol
        assert ordinary.sum() >= 3, (b, int(ordinary.sum()))
        off = beyond_tolerance(feat, w * (1 + 1e-3), w, lambda name: ref[name])
        assert off[ordinary].all(), (b, w[ordinary & ~off])
