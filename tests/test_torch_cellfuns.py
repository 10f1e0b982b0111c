"""The port's cellfuns, localisation, top-k reductions and overlap
extraction against the JAX package's, on the CPU.

- ``extract.cellfuns`` (mask, pixel and background metrics) and
  ``extract.localisation`` on label fields with absent labels, a NaN
  region and cells of 1 to 5 pixels: areas and NaN positions exact, every
  value within ``aliby_tpu_torch.extract.tolerances`` (FFT-derived
  localisation values: ``LOCALISATION_RTOL`` and ``LOCALISATION_ATOL_SHARE``).
- ``reductions.topk_mean_from_sorted`` (its running sum in XLA's blocked
  order: bit-equal), ``topk_median_from_sorted`` and
  ``distance_to_boundary`` exact.
- ``process_tree_masks_overlap`` on layered masks, every cellfuns, trap
  and localisation metric and a channel combination in the tree: the
  table's rows, original labels and columns equal, values within the
  tolerances, through the lazy result's columns and its pyarrow table; the
  materialised triple's instruction ids and inverse maps equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aliby_tpu.extract import cellfuns as JC
from aliby_tpu.extract import localisation as JL
from aliby_tpu.extract import reductions as JR
from aliby_tpu.extract.extract import format_extraction_overlap as jax_format_overlap
from aliby_tpu.extract.extract import process_tree_masks_overlap as jax_overlap
from aliby_tpu_torch.extract import cellfuns as C
from aliby_tpu_torch.extract import localisation as L
from aliby_tpu_torch.extract import reductions as R
from aliby_tpu_torch.extract.extract import (
    OverlapTreeResult,
    extraction_columns_overlap,
    format_extraction_overlap,
    process_tree_masks_overlap,
)
from aliby_tpu_torch.extract.tolerances import (
    INTEGER_VALUED,
    LOCALISATION_METRICS,
    beyond_tolerance,
)
from aliby_tpu_torch.test_data import render_cells

torch.set_num_threads(1)
ML = 32


def _fields(n=3, size=64, seed=5):
    """Label maps (absent labels, 1- to 5-pixel cells) and images (a NaN
    region in the last) as numpy."""
    rng = np.random.default_rng(seed)
    labels, imgs = [], []
    for i in range(n):
        cells, nuclei, lab = render_cells(size, 6, rng)
        lab = lab.copy()
        lab[lab == 2] = 0  # an absent label
        lab[2, 2] = 9  # a 1-pixel cell
        lab[5:7, 60:62] = 10  # a 4-pixel cell
        lab[60, 10:15] = 11  # a 5-pixel cell
        img = (cells * 3000 + nuclei * 5000 + rng.normal(200, 20, (size, size))).astype(np.float32)
        if i == n - 1:
            img[40:44, 40:44] = np.nan
        labels.append(lab.astype(np.int32))
        imgs.append(img)
    return np.stack(labels), np.stack(imgs)


def _check(name, got, want, ref=None):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=name)
    if name in INTEGER_VALUED or name == "area":
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    refs = ref or {}
    bad = beyond_tolerance(name, got, want, lambda other: np.asarray(refs.get(other, want)))
    assert not bad.any(), (name, got[bad], want[bad])


def _jax(fn, *args):
    return jax.tree_util.tree_map(np.asarray, jax.vmap(fn)(*[jnp.asarray(a) for a in args]))


def test_mask_metrics():
    labels, _ = _fields()
    got = C.mask_metrics(torch.from_numpy(labels), ML)
    want = _jax(lambda l: JC.mask_metrics(l, ML), labels)
    assert set(got) == set(want) == set(C.MASK_METRICS)
    for k in want:
        _check(k, got[k], want[k])
    mn, mj = C.min_maj_approximation(torch.from_numpy(labels), ML)
    jmn, jmj = _jax(lambda l: JC.min_maj_approximation(l, ML), labels)
    np.testing.assert_array_equal(mn.numpy(), jmn)
    np.testing.assert_array_equal(mj.numpy(), jmj)


def test_pixel_metrics():
    labels, imgs = _fields()
    got = C.pixel_metrics(torch.from_numpy(labels), torch.from_numpy(imgs), ML)
    want = _jax(lambda l, im: JC.pixel_metrics(l, im, ML), labels, imgs)
    assert set(got) == set(want) == set(C.PIXEL_METRICS)
    for k in want:
        _check(k, got[k], want[k], ref={"mean": want["mean"]})
    # the 1- to 5-pixel cells have no max5px_median; the NaN region poisons its cell
    assert np.isnan(got["max5px_median"][:, 8:11].numpy()).all()


def test_background_metrics():
    labels, imgs = _fields()
    labels[1, :, :] = np.where(labels[1] == 0, 1, labels[1])  # a tile with no background
    got = C.background_metrics(torch.from_numpy(labels), torch.from_numpy(imgs))
    want = _jax(JC.background_metrics, labels, imgs)
    for k in want:
        _check(k, got[k], want[k])
    assert np.isnan(got["imBackground"][1].item())


def test_topk_reductions_and_distance_to_boundary():
    labels, imgs = _fields()
    imgs = np.nan_to_num(imgs)
    sv, starts, cnt = R.sorted_by_label(torch.from_numpy(imgs), torch.from_numpy(labels), ML)

    def jax_sorted(l, im):
        return JR.sorted_by_label(im, l, ML)

    jsv, jstarts, jcnt = _jax(jax_sorted, labels, imgs)
    for frac in (0.025, 0.3, 1.0):
        got = R.topk_mean_from_sorted(sv, starts, cnt, frac).numpy()
        want = np.asarray(jax.vmap(lambda a, b, c: JR.topk_mean_from_sorted(a, b, c, frac))(
            jsv, jstarts, jcnt))
        np.testing.assert_array_equal(got, want)
    for k in (1, 4, 5):
        got = R.topk_median_from_sorted(sv, starts, cnt, k).numpy()
        want = np.asarray(jax.vmap(lambda a, b, c: JR.topk_median_from_sorted(a, b, c, k))(
            jsv, jstarts, jcnt))
        np.testing.assert_array_equal(got, want)
    for max_iter in (3, 64):
        got = R.distance_to_boundary(torch.from_numpy(labels), max_iter=max_iter).numpy()
        want = _jax(lambda l: JR.distance_to_boundary(l, max_iter=max_iter), labels)
        np.testing.assert_array_equal(got, want)


def test_cumsum_matches_xla_in_a_vmapped_batch():
    from aliby_tpu_torch.ops.imageops import cumsum_xla

    x = np.random.default_rng(0).random((3, 4099)).astype(np.float32) * 1000
    want = np.asarray(jax.vmap(jnp.cumsum)(jnp.asarray(x)))
    np.testing.assert_array_equal(cumsum_xla(torch.from_numpy(x)).numpy(), want)


@pytest.mark.parametrize("metric", LOCALISATION_METRICS)
def test_localisation(metric):
    labels, imgs = _fields()
    imgs = np.nan_to_num(imgs)
    got = L.compute(metric, torch.from_numpy(labels), torch.from_numpy(imgs), ML).numpy()
    want = np.asarray(jax.vmap(lambda l, im: JL.compute(metric, l, im, ML))(
        jnp.asarray(labels), jnp.asarray(imgs)))
    _check(metric, got, want)
    # a z stack is max-projected first
    z = np.stack([imgs, imgs * 0.5], axis=1)
    got_z = L.compute(metric, torch.from_numpy(labels), torch.from_numpy(z), ML).numpy()
    np.testing.assert_array_equal(got_z, got)


TREE = {
    "None": {"None": ["area", "eccentricity", "volume", "conical_volume", "spherical_volume",
                      "centroid_x", "centroid_y"]},
    1: {"max": ["mean", "total", "total_squared", "median", "max2p5pc", "max5px_median", "std",
                "moment_of_inertia", "imBackground", "background_max5", "nuc_est_conv",
                "small_peaks_conv"]},
    (0, 1): {"div": {"max": ["mean", "std"]}},
}


def _layered_tiles(n_tiles=2, size=80, seed=3):
    """Per-tile (3, Y, X) layered masks (BABY's layout: label k in layer
    k % 3, sparse original labels, one empty layer) and (F, 2, 2, Y, X)
    pixels."""
    rng = np.random.default_rng(seed)
    masks, pixels = [], []
    for t in range(n_tiles):
        cells, nuclei, lab = render_cells(size, 8, rng)
        lab = np.where(lab > 0, lab * 7 + t, 0)  # sparse, tile-dependent ids
        if t == 1:
            lab[lab % 3 == 2] = 0  # layer 2 empty
        layered = np.zeros((3, size, size), np.uint16)
        for v in np.unique(lab)[1:]:
            layered[v % 3][lab == v] = v
        masks.append(layered)
        ch0 = cells * 2000 + rng.normal(100, 5, (2, size, size))
        ch1 = nuclei * 4000 + rng.normal(150, 5, (2, size, size))
        pixels.append(np.stack([ch0, ch1]).astype(np.float32))
    return masks, np.stack(pixels)


def _assert_overlap_columns(got: dict, want):
    assert list(got) == want.column_names
    for name in want.column_names:
        w = np.asarray(want.column(name).to_pylist(), dtype=np.float64 if "/" in name else None)
        if name.startswith("metadata_"):
            assert got[name].tolist() == w.tolist(), name
            continue
        branch, feat = name.rsplit("/", 1)
        ref = {f: np.asarray(want.column(f"{branch}/{f}").to_pylist(), np.float64)
               for f in ("mean",) if f"{branch}/{f}" in want.column_names}
        _check(feat, np.asarray(got[name], np.float64), w, ref=ref)


def test_overlap_extraction():
    masks, pixels = _layered_tiles()
    got = process_tree_masks_overlap(TREE, masks, pixels, device="cpu")
    want = jax_overlap(TREE, masks, pixels)
    assert isinstance(got, OverlapTreeResult) and len(got) == 3
    insts, results, inverse = got
    j_insts, j_results, j_inverse = want
    assert insts == j_insts
    assert inverse.keys() == j_inverse.keys()
    for k in inverse:
        np.testing.assert_array_equal(inverse[k], j_inverse[k])
    want_table = jax_format_overlap(want)
    assert want_table.num_rows >= 6
    _assert_overlap_columns(extraction_columns_overlap(got), want_table)
    for got_v, want_v in zip(results, j_results):
        if isinstance(want_v, dict):
            assert got_v.keys() == want_v.keys()
    table = format_extraction_overlap(got)
    assert table.column_names == want_table.column_names
    assert table.column("metadata_label").to_pylist() == \
        want_table.column("metadata_label").to_pylist()


def test_overlap_extraction_of_empty_masks():
    masks, pixels = _layered_tiles()
    empty = [np.zeros_like(m) for m in masks]
    got = process_tree_masks_overlap(TREE, empty, pixels, device="cpu")
    cols = extraction_columns_overlap(got)
    assert list(cols) == ["metadata_tile", "metadata_label"] and not len(cols["metadata_tile"])
    assert tuple(got)[:2] == ((), [])
