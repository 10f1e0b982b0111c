"""The threshold segmenter's primitives and the segmenter itself against
the JAX package, on the CPU.

Exact (bit-equal or equal labels): ``cumsum_xla`` against ``jnp.cumsum``
(XLA's blocked order), ``histogram`` and ``otsu_threshold`` on the same
input, ``max_filter``, ``peak_local_max`` (``lax.top_k``'s tie order past
``max_peaks`` on a plateau-heavy EDT), ``connected_components`` (the
reference's rounds exactly, also where they leave a spiral unfinished),
``label_onehot``, ``segment_sum``, and ``threshold_segment`` batched over
the tiles of a call (the reference ``vmap``s ``_threshold_segment_2d``)
and through ``dispatch_segmenter("threshold")``.

Within a tolerance: ``gaussian_blur`` (rtol 1e-6 of the image's largest
value: its taps sum in another order than XLA's convolution, and the taps
themselves differ in the last bit). The segmenter's labels are equal on
these fixtures all the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aliby_tpu.models.segment import _threshold_segment_2d
from aliby_tpu.models.segment import dispatch_segmenter as jax_dispatch_segmenter
from aliby_tpu.ops import edt as JE
from aliby_tpu.ops import imageops as JI
from aliby_tpu.ops import labels as JLab
from aliby_tpu_torch.models.segment import dispatch_segmenter, threshold_segment
from aliby_tpu_torch.ops import imageops as I
from aliby_tpu_torch.ops import labels as Lab
from aliby_tpu_torch.test_data import render_cells, yeast_timelapse

torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))


def _yeast_tiles():
    """Channel 1 of a 128 x 128 yeast time-lapse, z max-projected: (3, Y, X)."""
    return yeast_timelapse(41, T=3, size=128)[:, 1].max(axis=1).astype(np.float32)


@pytest.mark.parametrize("n", [1, 16, 17, 256, 4099])
def test_cumsum_is_xla_order(n):
    x = (np.random.default_rng(n).random((2, n)) ** 3).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(jnp.cumsum))(jnp.asarray(x)))
    np.testing.assert_array_equal(I.cumsum_xla(_t(x)).numpy(), want)


def test_histogram_and_otsu_bit_equal():
    imgs = _yeast_tiles()
    blurred = np.stack([np.asarray(JI.gaussian_blur(jnp.asarray(im), 1.5)) for im in imgs])
    rng = np.random.default_rng(1)
    cases = [blurred, rng.normal(0, 1, (2, 40, 50)).astype(np.float32),
             np.full((1, 8, 8), 3.0, np.float32)]
    for batch in cases:
        counts, edges = I.histogram(_t(batch))
        thr = I.otsu_threshold(_t(batch)).numpy()
        for b, im in enumerate(batch):
            jc, je = JI.histogram(jnp.asarray(im))
            np.testing.assert_array_equal(counts[b].numpy(), np.asarray(jc))
            np.testing.assert_array_equal(edges[b].numpy(), np.asarray(je))
            assert thr[b] == np.float32(JI.otsu_threshold(jnp.asarray(im)))


def test_gaussian_blur_within_rtol():
    imgs = _yeast_tiles()
    got = I.gaussian_blur(_t(imgs), 1.5).numpy()
    for b, im in enumerate(imgs):
        want = np.asarray(JI.gaussian_blur(jnp.asarray(im), 1.5))
        assert np.abs(got[b] - want).max() <= 1e-6 * np.abs(want).max()
    np.testing.assert_allclose(I.gaussian_kernel1d(1.5), np.asarray(JI.gaussian_kernel1d(1.5)),
                               rtol=1e-6)


@pytest.mark.parametrize("size", [3, 17, 41])
def test_max_filter_exact(size):
    x = np.random.default_rng(size).normal(0, 1, (2, 50, 37)).astype(np.float32)
    got = I.max_filter(_t(x), size).numpy()
    for b in range(2):
        np.testing.assert_array_equal(got[b], np.asarray(JI.max_filter(jnp.asarray(x[b]), size)))


def _plateau_edt():
    """An EDT over bars 3 pixels tall: each bar's centre row is a plateau of
    equal values, every pixel of it a local max, so candidates far exceed
    256 and tie in value (truncation picks by flat index)."""
    m = np.zeros((96, 96), bool)
    for y in range(2, 92, 5):
        m[y:y + 3, 3:33] = True
        m[y:y + 3, 36:93] = True
    return np.asarray(JE.edt_to_other_label(jnp.asarray(m.astype(np.int32))))


@pytest.mark.parametrize("case", ["random", "plateaus"])
def test_peak_local_max_order(case):
    if case == "random":
        img = np.random.default_rng(4).normal(0, 1, (80, 70)).astype(np.float32)
        md, thr, k = 3, 0.5, 64
    else:
        img = _plateau_edt()
        md, thr, k = 1, 1.0, 256
        cand = (img >= np.asarray(JI.max_filter(jnp.asarray(img), 3))) & (img > thr)
        assert cand.sum() > 256
    coords, valid = I.peak_local_max(_t(img[None]), md, thr, max_peaks=k)
    jc, jv = JI.peak_local_max(jnp.asarray(img), min_distance=md, threshold=thr, max_peaks=k)
    np.testing.assert_array_equal(valid[0].numpy(), np.asarray(jv))
    np.testing.assert_array_equal(coords[0].numpy()[np.asarray(jv)], np.asarray(jc)[np.asarray(jv)])


def _spiral(n=64, width=1):
    """A one-pixel-wide square spiral: one component whose geodesic length
    (~n^2 / 2) 24 rounds of hooking and jumping do not cover."""
    m = np.zeros((n, n), bool)
    y, x, d = 0, 0, 0
    dirs = [(0, 1), (1, 0), (0, -1), (-1, 0)]
    lo, hi = [0, 0], [n - 1, n - 1]
    for _ in range(n * n):
        m[y, x] = True
        dy, dx = dirs[d]
        ny, nx = y + dy * 2, x + dx * 2
        if not (0 <= ny < n and 0 <= nx < n) or m[ny, nx] or m[y + dy, x + dx]:
            d = (d + 1) % 4
            dy, dx = dirs[d]
            ny, nx = y + dy * 2, x + dx * 2
            if not (0 <= ny < n and 0 <= nx < n) or m[ny, nx]:
                break
        m[y + dy, x + dx] = True
        y, x = ny, nx
    return m


@pytest.mark.parametrize("connectivity", [1, 2])
def test_connected_components_exact(connectivity):
    rng = np.random.default_rng(connectivity)
    masks = np.stack([rng.random((60, 70)) > 0.55, rng.random((60, 70)) > 0.4,
                      np.zeros((60, 70), bool)])
    got = Lab.connected_components(_t(masks), connectivity=connectivity).numpy()
    for b, m in enumerate(masks):
        want = np.asarray(JLab.connected_components(jnp.asarray(m), connectivity=connectivity))
        np.testing.assert_array_equal(got[b], want)


@pytest.mark.parametrize("n_iter", [2, 4, 5, 24])
def test_connected_components_unconverged_spiral(n_iter):
    """The reference's rounds exactly, finished or not: on a 96 x 96
    spiral 2, 4 and 5 rounds leave it in pieces (the partial ids must be
    the reference's); 24 finish it (any spiral up to 256 x 256 is finished
    after 8)."""
    m = _spiral(96)
    got = Lab.connected_components(_t(m[None]), n_iter=n_iter).numpy()[0]
    want = np.asarray(JLab.connected_components(jnp.asarray(m), n_iter=n_iter))
    np.testing.assert_array_equal(got, want)
    assert (len(np.unique(got[m])) > 1) == (n_iter < 6)


def test_label_onehot_and_segment_sum():
    rng = np.random.default_rng(2)
    _, _, lab = render_cells(64, 5, rng)
    vals = rng.normal(0, 1, lab.shape).astype(np.float32)
    np.testing.assert_array_equal(Lab.label_onehot(_t(lab), 8).numpy(),
                                  np.asarray(JLab.label_onehot(jnp.asarray(lab), 8)))
    got = Lab.segment_sum(_t(np.ones_like(vals)[None]), _t(lab[None]), 8).numpy()[0]
    want = np.asarray(JLab.segment_sum(jnp.ones(lab.size, jnp.float32), jnp.asarray(lab), 8))
    np.testing.assert_array_equal(got, want)


def test_threshold_segment_batched_equals_vmap():
    imgs = _yeast_tiles()
    kw = dict(min_distance=8, max_labels=256, min_size=20, threshold_scale=0.6)
    got = threshold_segment(_t(imgs), **kw).numpy()
    want = np.asarray(jax.vmap(lambda im: _threshold_segment_2d(im, **kw))(jnp.asarray(imgs)))
    np.testing.assert_array_equal(got, want)
    assert all(g.max() > 5 for g in got)


def test_threshold_dispatch_closure():
    stack = yeast_timelapse(42, T=1, size=96)[0]  # (C, Z, Y, X)
    pixels = np.stack([stack, stack[:, ::-1]])[None]  # (T=1, F=2, C, Z, Y, X)
    kw = dict(threshold_scale=0.8, min_size=10)
    got = dispatch_segmenter("threshold", channel_to_segment=1, device="cpu", **kw)(pixels)
    want = jax_dispatch_segmenter("threshold", channel_to_segment=1, **kw)(pixels)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == np.uint16
        np.testing.assert_array_equal(g, w)
