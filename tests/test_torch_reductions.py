"""Port parity: the per-label reductions of ``aliby_tpu_torch.extract.reductions``
against ``aliby_tpu.extract.reductions`` (JAX on the CPU, ``jax.vmap`` over
the port's batch axis), on touching and separate objects, max_labels 32.

Tolerance: exact (equal bits, equal NaN positions) for the label
statistics, the sort and its quantiles and MAD, row extents, convex area
and boundary masks. Directional extents and Feret diameters: rtol 1e-6 and
atol 1e-5 (the port takes cos/sin of the directions in float64 rounded
once; XLA:CPU's f32 cos/sin differ in the last bit at a few angles, which
moves a projection by up to one ulp of the direction times a coordinate of
at most 96 px). Central moments and the
ellipse: rtol 1e-6 (XLA:CPU fuses and reorders a few f32 products).

The minimum enclosing circle is held to the exact circle of the numpy
oracle (``oracle_features.o_minimum_enclosing_circle``): centre atol 1e-4
px, radius rtol 1e-5. Against the reference: the same where the reference
finds that circle; where its f32 search rejects it (the enclosure test
allows 1e-6 of r^2, f32 misses by ~1e-5 at coordinates near 100) the
reference's radius must be the larger one. Column sums past 32 columns:
bit-equal, column by column, to the ungrouped plain sum.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aliby_tpu.extract import reductions as R
from aliby_tpu.test_data import render_cells, render_dense_cells
from aliby_tpu_torch.extract import reductions as T

from oracle_features import o_minimum_enclosing_circle

torch.set_num_threads(1)
ML = 32


@pytest.fixture(scope="module")
def labels():
    rng = np.random.default_rng(17)
    sparse = render_cells(96, 10, rng)[2]
    dense = render_dense_cells(96, 30, rng, 3.0, 8.0)
    out = np.stack([sparse, dense]).astype(np.int32)
    assert 5 <= out.max() <= ML
    return out


def _exact(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.nan_to_num(got), np.nan_to_num(want))


def _vmap(fn, *arrays):
    return jax.vmap(fn)(*(jnp.asarray(a) for a in arrays))


def test_label_stats(labels):
    st = T.LabelStats(torch.from_numpy(labels), ML)
    area, cy, cx, present = _vmap(lambda l: (lambda s: (s.area, s.cy, s.cx, s.present))(
        R.LabelStats(l, ML)), labels)
    _exact(st.area, area)
    _exact(st.cy, cy)
    _exact(st.cx, cx)
    _exact(st.present, present)
    got = st.central_moments()
    want = _vmap(lambda l: R.LabelStats(l, ML).central_moments(), labels)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    for g, w in zip(st.centered_scaled_coords(),
                    _vmap(lambda l: R.LabelStats(l, ML).centered_scaled_coords(), labels)):
        _exact(g, w)
    ell = T.ellipse_params(*got, st.area)
    ell_ref = jax.vmap(R.ellipse_params)(*want, jnp.asarray(st.area.numpy()))
    for g, w in zip(ell, ell_ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_sorted_by_label_with_ties(labels):
    rng = np.random.default_rng(3)
    # quantised values: many ties inside each label, and signed zeros
    values = (rng.integers(-3, 4, labels.shape) * 0.25).astype(np.float32)
    values[values == 0] = np.where(rng.random((values == 0).sum()) < 0.5, -0.0, 0.0)
    sv, starts, cnt = T.sorted_by_label(torch.from_numpy(values), torch.from_numpy(labels), ML)
    w_sv, w_starts, w_cnt = _vmap(lambda v, l: R.sorted_by_label(v, l, ML), values, labels)
    _exact(sv, w_sv)
    _exact(starts, w_starts)
    _exact(cnt, w_cnt)
    for q in (0.25, 0.5, 0.75):
        _exact(T.quantile_from_sorted(sv, starts, cnt, q),
               jax.vmap(lambda a, b, c: R.quantile_from_sorted(a, b, c, q))(w_sv, w_starts, w_cnt))


def test_quantiles_and_mad(labels):
    rng = np.random.default_rng(4)
    values = rng.gamma(2.0, 1.0, labels.shape).astype(np.float32)
    sv, starts, cnt = T.sorted_by_label(torch.from_numpy(values), torch.from_numpy(labels), ML)
    med = T.quantile_from_sorted(sv, starts, cnt, 0.5)
    w_sv, w_starts, w_cnt = _vmap(lambda v, l: R.sorted_by_label(v, l, ML), values, labels)
    w_med = jax.vmap(lambda a, b, c: R.quantile_from_sorted(a, b, c, 0.5))(w_sv, w_starts, w_cnt)
    _exact(med, w_med)
    mad = T.mad_from_sorted(sv, starts, cnt, med)
    _exact(mad, jax.vmap(R.mad_from_sorted)(w_sv, w_starts, w_cnt, w_med))
    assert np.isnan(mad.numpy()).sum() == (cnt.numpy() == 0).sum()


def test_extents_feret_and_convex_area(labels):
    lab = torch.from_numpy(labels)
    for g, w in zip(T.label_row_extents(lab, ML), _vmap(lambda l: R.label_row_extents(l, ML),
                                                         labels)):
        _exact(g, w)
    pmax, pmin = T.directional_extents(lab, ML, n_dir=360)
    w_pmax, w_pmin = _vmap(lambda l: R.directional_extents(l, ML, n_dir=360), labels)
    present = np.isfinite(np.asarray(w_pmax))
    _exact(np.isfinite(pmax.numpy()), present)
    np.testing.assert_allclose(pmax.numpy()[present], np.asarray(w_pmax)[present], rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(pmin.numpy()[present], np.asarray(w_pmin)[present], rtol=1e-6,
                               atol=1e-5)
    for g, w in zip(T.feret_diameters(pmax, pmin), jax.vmap(R.feret_diameters)(w_pmax, w_pmin)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-5)
    area = T.convex_area_pixels(lab, ML, pmax=pmax[..., ::2], pmin=pmin[..., ::2], n_dir=180)
    w_area = _vmap(lambda l, a, b: R.convex_area_pixels(l, ML, a, b, 180), labels,
                   np.asarray(w_pmax)[..., ::2], np.asarray(w_pmin)[..., ::2])
    _exact(area, w_area)
    _exact(T.convex_area_pixels(lab, ML, n_dir=64),
           _vmap(lambda l: R.convex_area_pixels(l, ML, n_dir=64), labels))


@pytest.mark.parametrize("connectivity", [4, 8])
def test_boundary_mask(labels, connectivity):
    _exact(T.boundary_mask(torch.from_numpy(labels), connectivity),
           _vmap(lambda l: R.boundary_mask(l, connectivity), labels))


def test_counts_and_sums(labels):
    lab = torch.from_numpy(labels)
    _exact(T.counts(lab, ML), _vmap(lambda l: R.counts(l, ML), labels))
    rng = np.random.default_rng(5)
    v = rng.normal(size=labels.shape + (3,)).astype(np.float32)
    np.testing.assert_allclose(T.seg_sum_cols(torch.from_numpy(v), lab, ML).numpy(),
                               np.asarray(_vmap(lambda a, l: R.seg_sum_cols(a, l, ML), v, labels)),
                               rtol=1e-5, atol=1e-5)


def _symmetric_objects():
    """Objects whose farthest endpoints tie: a disk, a square, a line, one
    pixel, a rectangle."""
    lab = np.zeros((96, 96), np.int32)
    yy, xx = np.mgrid[0:96, 0:96]
    lab[(yy - 20) ** 2 + (xx - 20) ** 2 <= 100] = 1
    lab[30:50, 60:80] = 2
    lab[60:61, 10:40] = 3
    lab[70, 70] = 4
    lab[80:90, 20:25] = 5
    return lab


def test_minimum_enclosing_circle(labels):
    lab = np.concatenate([labels, _symmetric_objects()[None]])
    got = [a.numpy() for a in T.minimum_enclosing_circle(torch.from_numpy(lab), ML)]
    want = [np.asarray(a) for a in _vmap(lambda l: R.minimum_enclosing_circle(l, ML), lab)]
    n_obj = n_reference_misses = 0
    for b in range(lab.shape[0]):
        for k in range(1, lab[b].max() + 1):
            if not (lab[b] == k).any():
                continue
            n_obj += 1
            cy, cx, r = o_minimum_enclosing_circle(lab[b] == k)
            g = [a[b, k - 1] for a in got]
            np.testing.assert_allclose(g[:2], [cy, cx], rtol=0, atol=1e-4)
            np.testing.assert_allclose(g[2], r, rtol=1e-5, atol=1e-6)
            w = [a[b, k - 1] for a in want]
            if abs(w[2] - r) <= 1e-5 * r:
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-4)
            else:
                n_reference_misses += 1
                assert w[2] > g[2]
    assert n_obj >= 30 and n_reference_misses <= n_obj // 4
    # the symmetric objects: exact centres and radii
    np.testing.assert_array_equal(got[0][2, :5], [20.0, 39.5, 60.0, 70.0, 84.5])
    np.testing.assert_array_equal(got[1][2, :5], [20.0, 69.5, 24.5, 70.0, 22.0])
    np.testing.assert_array_equal(got[2][2, [0, 2, 3]], [10.0, 14.5, 0.0])


@pytest.mark.parametrize("K", [31, 32, 63, 367])
def test_column_groups_keep_every_bit(labels, K):
    """Past 31 columns ``binned_sum_cols`` sums in groups of 31 beside one
    shared indicator column: each column's sum is the bits of the plain sum
    of that column alone, and a non-finite value anywhere makes NaN in all
    K columns of its bin."""
    from aliby_tpu_torch.ops.segsum import binned_sum_cols_batched_plain

    rng = np.random.default_rng(K)
    lab = torch.from_numpy(labels[:, :48, :48].copy())
    vals = torch.from_numpy(rng.normal(0, 3, (2, 48, 48, K)).astype(np.float32))
    got = T.binned_sum_cols(vals, lab, ML + 1)
    assert got.shape == (2, ML + 1, K)
    for k in (0, 30, 31, K // 2, K - 1):
        if k < K:
            alone = binned_sum_cols_batched_plain(vals[..., k:k + 1].contiguous(), lab, ML + 1)
            assert torch.equal(got[..., k], alone[..., 0])
    y, x = np.argwhere(labels[1, :48, :48] > 0)[0]
    hit = int(labels[1, y, x])
    vals[1, y, x, K - 1] = float("inf")
    poisoned = T.binned_sum_cols(vals, lab, ML + 1)
    assert torch.isnan(poisoned[1, hit]).all() and torch.isnan(poisoned).sum() == K
    keep = torch.ones(2, ML + 1, dtype=torch.bool)
    keep[1, hit] = False
    assert torch.equal(poisoned[keep], got[keep])
    np.testing.assert_array_equal(
        T.seg_sum_cols(vals, lab, ML).numpy(), poisoned[:, 1:].numpy())


def test_no_columns_is_an_error(labels):
    lab = torch.from_numpy(labels[:, :48, :48].copy())
    with pytest.raises(ValueError, match="at least one column"):
        T.binned_sum_cols(torch.zeros(2, 48, 48, 0), lab, ML + 1)
