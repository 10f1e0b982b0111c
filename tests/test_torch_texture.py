"""Port parity: ``aliby_tpu_torch.extract.texture`` against
``aliby_tpu.extract.texture`` (JAX on the CPU, ``jax.vmap`` over the port's
batch axis), on one field of separate cells and one of touching cells,
96x96, max_labels 16, and a 260x260 field for the two-pass argmax.

Tolerance:

- exact (equal integers): ``_run_lengths``, texture's gray-level raster on
  the foreground, the ring and wedge rasters of the radial distribution
  (held to the reference's lines ``texture.py:581-624`` written out with the
  JAX package's own functions), the most interior pixel (both branches,
  also against a numpy argmax), and every granularity feature (min, max and
  one sum in pixel order);
- the features: ``aliby_tpu_torch.extract.tolerances`` (rtol 1e-5 with the
  Haralick and zernike rules stated there);
- the zernike families are compared twice, and no object leaves the
  comparison. The reference's f32 search for the minimum enclosing circle
  rejects the true circle of some objects away from the origin and keeps a
  radius a few percent too large, where the port's float64 search returns
  the exact circle
  (``tests/test_torch_reductions.py::test_minimum_enclosing_circle``). So
  (a) every object is held to the reference's own arithmetic
  (``zernike_family_multi``, run eagerly) fed with the port's circle, and
  (b) the objects whose circle the reference finds, at least 90% of them
  on these fields, are held to the reference as it stands.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aliby_tpu.extract import reductions as JR
from aliby_tpu.extract import texture as J
from aliby_tpu.ops.edt import edt_to_other_label as jax_edt_to_other_label
from aliby_tpu.test_data import render_cells, render_dense_cells
from aliby_tpu_torch.extract import reductions as TR
from aliby_tpu_torch.extract import texture as T
from aliby_tpu_torch.ops.edt import edt_to_other_label
from test_torch_features import check_feature

torch.set_num_threads(1)
ML = 16


def make_field(size, seed, n_sparse=8, n_dense=14):
    rng = np.random.default_rng(seed)
    cells, _, sparse = render_cells(size, n_sparse, rng)
    dense = render_dense_cells(size, n_dense, rng, 3.0, 8.0)
    labels = np.stack([sparse, dense]).astype(np.int32)
    assert 3 <= labels.max() <= ML
    yy, xx = np.mgrid[0:size, 0:size] / float(size)
    wave = (np.sin(9 * xx) * np.cos(7 * yy)) ** 2  # varies inside every touching cell
    img = np.stack([cells, (dense > 0) * (0.2 + wave)]).astype(np.float32)
    return labels, img + rng.normal(0.02, 0.01, img.shape).astype(np.float32)


@pytest.fixture(scope="module")
def field():
    return make_field(96, 23)


def _vmap(fn, *arrays):
    return jax.vmap(fn)(*(jnp.asarray(a) for a in arrays))


def reference_finds_the_circle(labels: np.ndarray, max_labels: int) -> np.ndarray:
    """(B, max_labels) mask of the objects on which the reference's minimum
    enclosing circle has the port's radius (within 1e-5)."""
    want = np.asarray(_vmap(lambda l: JR.minimum_enclosing_circle(l, max_labels), labels)[2])
    got = TR.minimum_enclosing_circle(torch.from_numpy(labels), max_labels)[2].numpy()
    assert (want >= got * (1 - 1e-5)).all()  # the port's circle is never the larger one
    present = TR.counts(torch.from_numpy(labels), max_labels).numpy() > 0
    same = np.abs(want - got) <= 1e-5 * got
    assert (same & present).sum() >= 0.9 * present.sum()
    return same


def reference_on_the_ports_circle(labels, imgs, with_mask: bool, max_labels: int):
    """The reference's ``zernike_family_multi`` on (B, H, W) labels and
    (B, C, H, W) weight rasters, with the port's minimum enclosing circle in
    place of its own: ``(mask dict or None, [dict per raster])`` of
    {(n, m): (B, max_labels)} arrays. The function is run eagerly, field by
    field, so no compiled trace keeps the replaced circle."""
    circle = [a.numpy() for a in TR.minimum_enclosing_circle(torch.from_numpy(labels), max_labels)]
    original, outs = JR.minimum_enclosing_circle, []
    try:
        for b in range(len(labels)):
            JR.minimum_enclosing_circle = lambda l, ml, b=b: tuple(jnp.asarray(a[b])
                                                                   for a in circle)
            outs.append(J.zernike_family_multi(jnp.asarray(labels[b]), jnp.asarray(imgs[b]),
                                               with_mask, max_labels))
    finally:
        JR.minimum_enclosing_circle = original

    def stack(dicts):
        return {k: np.stack([np.asarray(d[k]) for d in dicts]) for k in dicts[0]}

    mask = stack([o[0] for o in outs]) if with_mask else None
    return mask, [stack([o[1][c] for o in outs]) for c in range(imgs.shape[1])]


def _compare(got: dict, want: dict, keep=None):
    """``keep``: the (B, L) objects to compare (NaN sits at the same places
    on all of them); all where it is None."""
    assert sorted(got) == sorted(want)
    want = {k: np.asarray(w).copy() for k, w in want.items()}
    got = {k: g.numpy().copy() for k, g in got.items()}
    if keep is not None:
        for k in want:
            np.testing.assert_array_equal(np.isnan(got[k]), np.isnan(want[k]), err_msg=k)
            want[k][~keep] = np.nan
            got[k][~keep] = np.nan
    for k, w in want.items():
        assert got[k].shape == w.shape
        check_feature(k, got[k], w, lambda name: want[name])


def test_run_lengths():
    rng = np.random.default_rng(0)
    keys = np.sort(rng.integers(0, 40, (3, 500)).astype(np.int32), axis=1)
    keys[1] = 7  # one run
    keys[2] = np.arange(500)  # all runs of one
    want_len, want_rs = _vmap(lambda k: J._run_lengths(k, jnp.int32(10_000)), keys)
    got_len, got_rs = T._run_lengths(torch.from_numpy(keys), 10_000)
    assert got_len.dtype == torch.int32
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(want_len))
    np.testing.assert_array_equal(got_rs.numpy(), np.asarray(want_rs))


def _jax_quantize(labels, img):
    """``texture.py:181-189`` of the reference."""
    mn, mx = JR.seg_minmax_cols(img[..., None], labels, ML)
    vmin = jnp.nan_to_num(mn[:, 0], posinf=0.0)
    vmax = jnp.nan_to_num(mx[:, 0], neginf=0.0)
    span = jnp.maximum(vmax - vmin, 1e-12)
    lk = JR.table_lookup(jnp.stack([vmin, span], axis=-1), jnp.clip(labels - 1, 0, ML - 1))
    return jnp.clip(((img - lk[..., 0]) / lk[..., 1] * 256).astype(jnp.int32), 0, 255)


def test_gray_levels_bit_equal(field):
    labels, img = field
    want = np.asarray(_vmap(_jax_quantize, labels, img))
    got = T.quantize(torch.from_numpy(labels), torch.from_numpy(img), ML).numpy()
    assert got.dtype == np.int32 and got.min() >= 0 and got.max() == 255
    fg = labels > 0
    np.testing.assert_array_equal(got[fg], want[fg])


def test_texture(field):
    labels, img = field
    want = _vmap(lambda l, im: J.texture(l, im, ML), labels, img)
    got = T.texture(torch.from_numpy(labels), torch.from_numpy(img), ML)
    assert len(got) == 52
    _compare(got, want)


def test_granularity_bit_equal(field):
    labels, img = field
    want = _vmap(lambda l, im: J.granularity(l, im, ML), labels, img)
    got = T.granularity(torch.from_numpy(labels), torch.from_numpy(img), ML)
    assert sorted(got) == sorted(want) and len(got) == 16
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(w), err_msg=k)


def test_zernike_and_radial_zernikes(field):
    labels, img = field
    keep = reference_finds_the_circle(labels, ML)
    lab, im = torch.from_numpy(labels), torch.from_numpy(img)
    got = T.zernike(lab, ML)
    got_radial = T.radial_zernikes(lab, im, ML)
    assert len(got) == 30 and "Zernike_9_9" in got
    _compare(got, _vmap(lambda l: J.zernike(l, ML), labels), keep)
    _compare(got_radial, _vmap(lambda l, i: J.radial_zernikes(l, i, ML), labels, img), keep)
    on_mask, (on_img,) = reference_on_the_ports_circle(labels, img[:, None], True, ML)
    _compare(got, {f"Zernike_{n}_{m}": v for (n, m), v in on_mask.items()})
    _compare(got_radial, {f"RadialZernike_{n}_{m}": v for (n, m), v in on_img.items()})


@pytest.mark.parametrize("with_mask", [True, False])
def test_zernike_family_multi_poisons_one_entry(field, with_mask):
    """Three weight rasters at once; a NaN pixel inside one object of the
    second channel makes NaN in that channel's entry, for that object, and
    nowhere else."""
    labels, img = field
    imgs = np.stack([img, img[:, ::-1].copy() + 0.5, np.sqrt(np.abs(img))], axis=1)
    y, x = np.argwhere(labels[0] == 2)[3]
    imgs[0, 1, y, x] = np.nan
    keep = reference_finds_the_circle(labels, ML)
    w_mask, w_imgs = _vmap(lambda l, im: J.zernike_family_multi(l, im, with_mask, ML),
                           labels, imgs)
    g_mask, g_imgs = T.zernike_family_multi(torch.from_numpy(labels), torch.from_numpy(imgs),
                                            with_mask, ML)
    c_mask, c_imgs = reference_on_the_ports_circle(labels, imgs, with_mask, ML)
    assert (g_mask is None) == (not with_mask) and len(g_imgs) == 3
    entries = (([(g_mask, w_mask, c_mask)] if with_mask else [])
               + list(zip(g_imgs, w_imgs, c_imgs)))
    for e, (g, w, c) in enumerate(entries):
        name = lambda nm: f"Zernike_{nm[0]}_{nm[1]}"  # noqa: E731
        _compare({name(k): v for k, v in g.items()}, {name(k): v for k, v in w.items()}, keep)
        _compare({name(k): v for k, v in g.items()}, {name(k): v for k, v in c.items()})
        poisoned = torch.isnan(g[(4, 2)]) & torch.from_numpy(labels.max(axis=(1, 2))[:, None]
                                                             > np.arange(ML)[None])
        expect = torch.zeros(2, ML, dtype=torch.bool)
        if e == len(entries) - 2:  # the second channel
            expect[0, 1] = True
        assert torch.equal(poisoned, expect), e


def _jax_rings_and_wedges(labels, n_bins=4, n_wedges=8):
    """``texture.py:581-624`` of the reference: (d_edge, first, ring, wedge)."""
    st = JR.LabelStats(labels, ML)
    l_idx = jnp.clip(labels - 1, 0, ML - 1)
    H, W = labels.shape
    d_edge = jnp.where(labels > 0, jax_edt_to_other_label(labels), 0.0)
    flat_l = jnp.clip(labels, 0, ML).reshape(-1)
    fgf = (labels > 0).reshape(-1)
    pos = jnp.arange(H * W, dtype=jnp.int32)
    i32max = jnp.iinfo(jnp.int32).max
    if H * W <= (1 << 16):
        d2i = jnp.minimum(jnp.round(d_edge * d_edge).astype(jnp.int32), (1 << 15) - 2).reshape(-1)
        key = ((((1 << 15) - 2) - d2i) << 16) | pos
        best = jnp.full(ML + 1, i32max, jnp.int32).at[jnp.where(fgf, flat_l, 0)].min(
            jnp.where(fgf, key, i32max))[1:]
        first = best & 0xFFFF
    else:
        d2i = jnp.round(d_edge * d_edge).astype(jnp.int32).reshape(-1)
        neg_best = jnp.full(ML + 1, i32max, jnp.int32).at[jnp.where(fgf, flat_l, 0)].min(
            jnp.where(fgf, -d2i, i32max))
        at_best = fgf & (d2i == -neg_best[flat_l])
        first = jnp.full(ML + 1, i32max, jnp.int32).at[jnp.where(at_best, flat_l, 0)].min(
            jnp.where(at_best, pos, i32max))[1:]
        first = jnp.where(first == i32max, 0, first)
    ccy = jnp.floor(first.astype(jnp.float32) / W)
    ccx = first.astype(jnp.float32) - ccy * W
    cc = JR.table_lookup(jnp.stack([ccy, ccx], axis=-1), l_idx)
    dy = st.yy - cc[..., 0]
    dx = st.xx - cc[..., 1]
    r = jnp.sqrt(dy**2 + dx**2)
    nd = r / (r + d_edge + 0.001)
    ring = jnp.clip((nd * n_bins).astype(jnp.int32), 0, n_bins - 1)
    theta = jnp.arctan2(dy, dx)
    wedge = jnp.clip(((theta + jnp.pi) / (2 * jnp.pi) * n_wedges).astype(jnp.int32), 0,
                     n_wedges - 1)
    return d_edge, first, ring, wedge


@pytest.mark.parametrize("size,seed", [(96, 23), (260, 31)])
def test_rings_wedges_and_centres_bit_equal(size, seed):
    """96x96 takes the packed int32 argmax, 260x260 (> 65,536 pixels) the
    two-pass form. Every object has pixels exactly on the 8 wedge edges
    (dy = 0, dx = 0, |dy| = |dx| about its integer centre)."""
    labels, _ = make_field(size, seed)
    lab = torch.from_numpy(labels)
    d_edge, w_first, w_ring, w_wedge = (np.asarray(a) for a in _vmap(_jax_rings_and_wedges, labels))
    g_edge = edt_to_other_label(lab)
    np.testing.assert_array_equal(g_edge.numpy(), d_edge)
    first = T._most_interior_pixel(lab, g_edge, ML).numpy()
    present = TR.counts(lab, ML).numpy() > 0
    np.testing.assert_array_equal(first[present], w_first[present])
    for b, k in zip(*np.nonzero(present)):  # the first raster position of the largest distance
        d = np.where(labels[b] == k + 1, d_edge[b], -1.0).ravel()
        assert first[b, k] == int(np.argmax(d))
    _, ring, wedge = T._rings_and_wedges(lab, ML, 4, 8)
    fg = labels > 0
    yy, xx = np.divmod(first, size)
    on_edge = 0
    for b, k in zip(*np.nonzero(present)):
        ys, xs = np.nonzero(labels[b] == k + 1)
        dy, dx = ys - yy[b, k], xs - xx[b, k]
        on_edge += int(((dy == 0) | (dx == 0) | (np.abs(dy) == np.abs(dx))).sum())
    assert on_edge > 8 * present.sum()
    np.testing.assert_array_equal(ring.numpy()[fg], w_ring[fg])
    np.testing.assert_array_equal(wedge.numpy()[fg], w_wedge[fg])
    assert set(np.unique(wedge.numpy()[fg])) == set(range(8))


@pytest.mark.parametrize("size,seed", [(96, 23), (260, 31)])
def test_radial_distribution(size, seed):
    labels, img = make_field(size, seed)
    want = _vmap(lambda l, im: J.radial_distribution(l, im, ML), labels, img)
    got = T.radial_distribution(torch.from_numpy(labels), torch.from_numpy(img), ML)
    assert len(got) == 12
    _compare(got, want)
