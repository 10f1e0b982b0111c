"""Port parity: the per-bin reductions of ``aliby_tpu_torch.ops.segsum``
(batched sums, min/max, table lookup; the unbatched ``segment_sum_matmul``)
and ``extract.reductions.binned_sum_cols``.

Tolerance: sums: counts exact, rtol 1e-5 (f32 sums taken in another order);
min/max and lookup: exact (equal values and equal NaN positions).

Min/max: a NaN value makes NaN in its own (bin, column) only, as in the
Pallas kernel and the JAX scatter. Lookup: a bin outside [0, L) gives 0 and
a non-finite table entry gives NaN, as in the Pallas kernel; the JAX CPU
gather (``reductions.table_lookup`` off the TPU) returns +-inf as it is. The
port follows the kernel path on every device (pinned below).

Bins outside [0, n_bins) add nothing, as in the Pallas kernel; the JAX
package's CPU scatter wraps a negative bin to n_bins + bin instead (the
segmentation path never makes one).

``segment_sum_matmul``: against ``segment_sum_auto`` of the JAX package (the
Pallas kernel in interpreter mode) at rtol 1e-4, atol 1e-3, the tolerance of
``tests/test_ops_labels.py``; labels outside [1, max_labels] add nothing on
both sides. A non-finite value: the reference's one-hot matmul multiplies it
by 0 for every other label, so the whole column is NaN for every label; the
port adds it to its own label only (pinned below).

Non-finite values: the JAX package's CPU scatter path gives ``+inf`` for an
``+inf`` input while its TPU kernel path (``_binned_sum_kernel_call``)
gives NaN for the whole bin. The port follows the kernel path on every
device, so that case is pinned against the Pallas kernel in interpreter
mode plus the same sanitisation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aliby_tpu.extract import reductions as R
from aliby_tpu.ops.pallas_segsum import binned_minmax_batched as jax_binned_minmax
from aliby_tpu.ops.pallas_segsum import binned_sum_cols_batched as jax_binned_sum
from aliby_tpu.ops.pallas_segsum import segment_sum_auto as jax_segment_sum_auto
from aliby_tpu.ops.pallas_segsum import table_lookup_batched as jax_table_lookup
from aliby_tpu_torch.extract.reductions import binned_sum_cols
from aliby_tpu_torch.ops import segsum

torch.set_num_threads(1)


def _inputs(B=3, N=5000, K=2, n_bins=257, seed=0):
    rng = np.random.default_rng(seed)
    vals = rng.normal(0, 2, (B, N, K)).astype(np.float32)
    vals[..., -1] = 1.0  # an indicator column: its sums are counts
    bins = rng.integers(-3, n_bins + 4, (B, N)).astype(np.int32)  # some out of range
    return vals, bins


def _check(got, want):
    np.testing.assert_array_equal(got[..., -1], want[..., -1])  # counts exact
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("n_bins", [1, 17, 257, 2176])
def test_binned_sum_cols_matches_jax(n_bins):
    vals, bins = _inputs(n_bins=n_bins)
    # the CPU scatter wraps negative bins NumPy-style; the kernel path (and
    # the port) drops them: compare on bins >= 0 here, negatives below
    bins = np.abs(bins)
    want = np.asarray(jax.vmap(lambda v, b: R.binned_sum_cols(v, b, n_bins))(
        jnp.asarray(vals), jnp.asarray(bins)))
    got = binned_sum_cols(torch.from_numpy(vals), torch.from_numpy(bins), n_bins)
    assert got.shape == (3, n_bins, 2) and got.dtype == torch.float32
    _check(got.numpy(), want)
    plain = segsum.binned_sum_cols_batched(torch.from_numpy(vals), torch.from_numpy(bins), n_bins)
    _check(plain.numpy(), want)


def test_binned_sum_cols_batched_matches_pallas_kernel():
    vals, bins = _inputs(B=2, N=3000, K=3, n_bins=65)  # bins in [-3, 69)
    assert (bins < 0).any() and (bins >= 65).any()
    want = np.asarray(jax_binned_sum(jnp.asarray(vals), jnp.asarray(bins), 65, interpret=True))
    got = segsum.binned_sum_cols_batched(torch.from_numpy(vals), torch.from_numpy(bins), 65)
    _check(got.numpy(), want)


def test_binned_sum_cols_image_shaped_and_int64_bins():
    rng = np.random.default_rng(2)
    vals = rng.random((2, 16, 24, 2)).astype(np.float32)
    bins = rng.integers(0, 9, (2, 16, 24)).astype(np.int64)
    want = np.asarray(jax.vmap(lambda v, b: R.binned_sum_cols(v, b, 9))(
        jnp.asarray(vals), jnp.asarray(bins.astype(np.int32))))
    got = binned_sum_cols(torch.from_numpy(vals), torch.from_numpy(bins), 9).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_non_finite_follows_the_kernel_path():
    vals, bins = _inputs(B=2, N=4000, K=2, n_bins=33, seed=4)
    bins = np.clip(bins, 0, 32)
    vals[0, 10, 0] = np.inf  # +inf: NaN on the kernel path, +inf on the CPU scatter
    vals[0, 20, 1] = np.nan
    vals[1, 30, 0] = -np.inf
    # _binned_sum_kernel_call, with the Pallas kernel in interpreter mode
    v = jnp.asarray(vals)
    finite = jnp.isfinite(v)
    flag = jnp.any(~finite, axis=-1, keepdims=True).astype(jnp.float32)
    out = jax_binned_sum(
        jnp.concatenate([jnp.where(finite, v, 0.0), flag], axis=-1), jnp.asarray(bins), 33,
        interpret=True,
    )
    want = np.asarray(jnp.where(out[..., -1:] > 0, jnp.nan, out[..., :-1]))
    got = binned_sum_cols(torch.from_numpy(vals), torch.from_numpy(bins), 33).numpy()
    poisoned = {(0, bins[0, 10]), (0, bins[0, 20]), (1, bins[1, 30])}
    for b, k in poisoned:
        assert np.isnan(got[b, k]).all() and np.isnan(want[b, k]).all()
    assert np.isnan(got).sum() == np.isnan(want).sum() == 2 * len(poisoned)
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-5, atol=1e-4)
    # the divergence from the JAX CPU scatter path, pinned
    scatter = np.asarray(jax.vmap(lambda v, b: R.binned_sum_cols(v, b, 33))(
        jnp.asarray(vals), jnp.asarray(bins)))
    assert scatter[0, bins[0, 10], 0] == np.inf and np.isnan(got[0, bins[0, 10], 0])


def test_validation():
    with pytest.raises(ValueError):
        segsum.binned_sum_cols_batched(torch.zeros(2, 5, 1), torch.zeros(2, 4, dtype=torch.int32), 3)
    with pytest.raises(TypeError):
        segsum.binned_sum_cols_batched(torch.zeros(2, 5, 1), torch.zeros(2, 5), 3)


def test_binned_sum_seventeen_columns():
    """sizeshape's 16 moment columns plus the non-finite indicator."""
    vals, bins = _inputs(B=2, N=4000, K=17, n_bins=33, seed=8)
    bins = np.abs(bins)
    want = np.asarray(jax.vmap(lambda v, b: R.binned_sum_cols(v, b, 33))(
        jnp.asarray(vals), jnp.asarray(bins)))
    got = segsum.binned_sum_cols_batched(torch.from_numpy(vals), torch.from_numpy(bins), 33)
    assert got.shape == (2, 33, 17)
    _check(got.numpy(), want)


def _equal_with_nan(got, want):
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.nan_to_num(got), np.nan_to_num(want))


def _minmax_inputs(B, N, K, n_bins, seed):
    rng = np.random.default_rng(seed)
    vals = rng.normal(0, 2, (B, N, K)).astype(np.float32)
    vals[0, 5, 0] = np.nan
    vals[-1, 7, K - 1] = np.nan
    bins = rng.integers(-3, n_bins + 4, (B, N)).astype(np.int32)
    bins[0, 5], bins[-1, 7] = 1, n_bins - 1
    return vals, bins


@pytest.mark.parametrize("K,n_bins", [(1, 17), (2, 65), (3, 257)])
def test_binned_minmax_matches_pallas_kernel(K, n_bins):
    vals, bins = _minmax_inputs(2, 3000, K, n_bins, seed=K)
    want_mn, want_mx = jax_binned_minmax(jnp.asarray(vals), jnp.asarray(bins), n_bins,
                                         interpret=True)
    mn, mx = segsum.binned_minmax_batched(torch.from_numpy(vals), torch.from_numpy(bins), n_bins)
    assert mn.shape == (2, n_bins, K) and np.isnan(mn.numpy()).sum() == 2
    _equal_with_nan(mn.numpy(), np.asarray(want_mn))
    _equal_with_nan(mx.numpy(), np.asarray(want_mx))


def test_seg_minmax_cols_matches_jax_scatter():
    from aliby_tpu_torch.extract import reductions as TR

    vals, bins = _minmax_inputs(3, 2500, 2, 33, seed=9)
    labels = np.abs(bins)  # the scatter wraps negative labels; labels are never negative
    want = jax.vmap(lambda v, l: R.seg_minmax_cols(v, l, 32))(jnp.asarray(vals),
                                                             jnp.asarray(labels))
    got = TR.seg_minmax_cols(torch.from_numpy(vals), torch.from_numpy(labels), 32)
    for g, w in zip(got, want):
        _equal_with_nan(g.numpy(), np.asarray(w))
    for init in (np.inf, 0.5):  # the kernel path and the custom-init scatter
        w_min = jax.vmap(lambda v, l: R.seg_min(v, l, 32, init=init))(
            jnp.asarray(vals[..., 1]), jnp.asarray(labels))
        g_min = TR.seg_min(torch.from_numpy(vals[..., 1]), torch.from_numpy(labels), 32, init=init)
        _equal_with_nan(g_min.numpy(), np.asarray(w_min))
    w_max = jax.vmap(lambda v, l: R.seg_max(v, l, 32, init=-1.0))(
        jnp.asarray(vals[..., 0]), jnp.asarray(labels))
    g_max = TR.seg_max(torch.from_numpy(vals[..., 0]), torch.from_numpy(labels), 32, init=-1.0)
    _equal_with_nan(g_max.numpy(), np.asarray(w_max))


def _lookup_inputs(B, N, L, K, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(0, 3, (B, L, K)).astype(np.float32)
    table[0, 1, 0], table[-1, 2, K - 1], table[0, 3, K - 1] = np.inf, -np.inf, np.nan
    bins = rng.integers(-3, L + 4, (B, N)).astype(np.int32)
    bins[0, :3] = 1
    bins[-1, :3] = 2
    return table, bins


@pytest.mark.parametrize("L,K", [(16, 1), (64, 3), (256, 3)])
def test_table_lookup_matches_pallas_kernel(L, K):
    table, bins = _lookup_inputs(2, 3000, L, K, seed=L)
    want = np.asarray(jax_table_lookup(jnp.asarray(table), jnp.asarray(bins), interpret=True))
    got = segsum.table_lookup_batched(torch.from_numpy(table), torch.from_numpy(bins)).numpy()
    assert got.shape == (2, 3000, K)
    assert (got[(bins < 0) | (bins >= L)] == 0).all()
    _equal_with_nan(got, want)


def test_table_lookup_infinities_follow_the_kernel_path():
    from aliby_tpu_torch.extract import reductions as TR

    table, bins = _lookup_inputs(2, 500, 16, 3, seed=11)
    got = TR.table_lookup(torch.from_numpy(table), torch.from_numpy(bins)).numpy()
    gather = np.asarray(jax.vmap(R.table_lookup)(jnp.asarray(table), jnp.asarray(bins)))
    assert gather.shape == got.shape == (2, 500, 3)
    # the JAX CPU gather keeps +-inf; the kernel path (and the port) gives NaN
    assert gather[0, 0, 0] == np.inf and np.isnan(got[0, 0, 0])
    assert gather[-1, 0, 2] == -np.inf and np.isnan(got[-1, 0, 2])
    finite = np.isfinite(gather) | np.isnan(gather)
    _equal_with_nan(got[finite], gather[finite])
    assert np.isnan(got[~finite]).all()


# The input families the redesigned min/max and lookup kernels are held to
# on the card (``tests/test_torch_kernels_cuda.py``): label images (objects
# on a background, the warp-aggregated case), every pixel in one bin, one
# pixel per bin, a ragged N (odd, N x K not a multiple of 4). Here the plain
# versions against the Pallas kernels in interpreter mode.

def _label_bins(B, H, W, n_bins, seed):
    """(B, H*W) int32 bins from synthetic label maps (label k -> bin k, the
    background bin 0), a few pixels dropped (-1, n_bins)."""
    from aliby_tpu_torch.test_data import render_cells

    rng = np.random.default_rng(seed)
    maps = [render_cells(128, 12, rng)[2][:H, :W] % n_bins for _ in range(B)]
    bins = np.stack(maps).reshape(B, H * W).astype(np.int32)
    bins[:, 1], bins[:, 2] = -1, n_bins
    return bins


def _zeros_equal(got, want):
    """Equal values and NaN positions, -0.0 == +0.0 (the reference's rule
    for signed zeros may differ; the port's own rule is pinned apart)."""
    _equal_with_nan(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("K", [1, 2, 3])
def test_binned_minmax_label_images_match_pallas_kernel(K):
    """Contiguous objects on a background, a ragged N (97 x 61), +-inf,
    NaN and signed zeros among the values."""
    B, H, W, n_bins = 2, 97, 61, 65
    bins = _label_bins(B, H, W, n_bins, seed=20 + K)
    assert len(np.unique(bins[0])) > 5
    rng = np.random.default_rng(K)
    vals = rng.normal(0, 2, (B, H * W, K)).astype(np.float32)
    vals[rng.random(vals.shape) < 0.05] = 0.0
    vals[rng.random(vals.shape) < 0.05] = -0.0
    vals[0, 100, 0], vals[1, 200, K - 1], vals[0, 300, 0] = np.inf, -np.inf, np.nan
    want = jax_binned_minmax(jnp.asarray(vals), jnp.asarray(bins), n_bins, interpret=True)
    got = segsum.binned_minmax_batched(torch.from_numpy(vals), torch.from_numpy(bins), n_bins)
    assert np.isnan(got[0].numpy()).sum() == 1
    for g, w in zip(got, want):
        _zeros_equal(g.numpy(), w)


@pytest.mark.parametrize("layout", ["one bin", "one pixel per bin"])
def test_binned_minmax_one_bin_and_one_pixel_per_bin(layout):
    rng = np.random.default_rng(5)
    B, N, K, n_bins = 2, 257, 2, 257
    vals = rng.normal(0, 2, (B, N, K)).astype(np.float32)
    if layout == "one bin":
        bins = np.zeros((B, N), np.int32)
    else:
        bins = np.stack([rng.permutation(n_bins)[:N] for _ in range(B)]).astype(np.int32)
    want = jax_binned_minmax(jnp.asarray(vals), jnp.asarray(bins), n_bins, interpret=True)
    got = segsum.binned_minmax_batched(torch.from_numpy(vals), torch.from_numpy(bins), n_bins)
    for g, w in zip(got, want):
        _zeros_equal(g.numpy(), w)
    if layout == "one pixel per bin":  # each bin holds its pixel's value
        np.testing.assert_array_equal(got[0].numpy(), got[1].numpy())


def test_binned_minmax_signed_zeros():
    """Against the Pallas kernel with -0.0 == +0.0; the port's rule where it
    is the same on every device: a bin of -0.0 only gives -0.0, a bin of
    +0.0 only gives +0.0. (A bin holding both gives min -0.0, max +0.0 on
    the card, pinned in the cuda tests; the plain version's scatter keeps
    whichever zero comes first.)"""
    vals = np.array([-0.0, -0.0, 0.0, 0.0, -0.0, 0.0, 1.0], np.float32).reshape(1, 7, 1)
    bins = np.array([[0, 0, 1, 1, 2, 2, 2]], np.int32)
    want = jax_binned_minmax(jnp.asarray(vals), jnp.asarray(bins), 3, interpret=True)
    mn, mx = (t.numpy()[0, :, 0] for t in segsum.binned_minmax_batched(
        torch.from_numpy(vals), torch.from_numpy(bins), 3))
    for g, w in zip((mn, mx), want):
        _zeros_equal(g, np.asarray(w)[0, :, 0])
    assert np.signbit(mn[0]) and np.signbit(mx[0])
    assert not np.signbit(mn[1]) and not np.signbit(mx[1])
    assert mn[2] == 0.0 and mx[2] == 1.0


@pytest.mark.parametrize("K", range(1, 9))
def test_table_lookup_every_width_matches_pallas_kernel(K):
    """Every K from 1 to 8 on a ragged N (1,001 pixels: N x K is not a
    multiple of 4 for odd K), +-inf and NaN entries, bins out of range."""
    table, bins = _lookup_inputs(3, 1001, 64, K, seed=30 + K)
    want = np.asarray(jax_table_lookup(jnp.asarray(table), jnp.asarray(bins), interpret=True))
    got = segsum.table_lookup_batched(torch.from_numpy(table), torch.from_numpy(bins)).numpy()
    assert got.shape == (3, 1001, K)
    _zeros_equal(got, want)


@pytest.mark.parametrize("layout", ["label image", "one bin"])
def test_table_lookup_label_images_match_pallas_kernel(layout):
    B, H, W, L, K = 2, 97, 61, 64, 3
    table, _ = _lookup_inputs(B, 1, L, K, seed=40)
    table[0, 0] = -0.0
    if layout == "label image":
        bins = _label_bins(B, H, W, L, seed=41)
    else:
        bins = np.full((B, H * W), 5, np.int32)
    want = np.asarray(jax_table_lookup(jnp.asarray(table), jnp.asarray(bins), interpret=True))
    got = segsum.table_lookup_batched(torch.from_numpy(table), torch.from_numpy(bins)).numpy()
    _zeros_equal(got, want)
    # a copy: the bits of the entry it reads, -0.0 included
    ok = (bins >= 0) & (bins < L)
    rows = table[np.arange(B)[:, None], np.clip(bins, 0, L - 1)]
    finite = np.isfinite(rows)
    assert np.array_equal(got[ok & finite.all(-1)].view(np.int32),
                          rows[ok & finite.all(-1)].view(np.int32))


def _segment_inputs(N, K, max_labels, seed):
    rng = np.random.default_rng(seed)
    vals = rng.normal(0, 2, (N, K)).astype(np.float32)
    vals[:, -1] = 1.0  # its sums are counts
    labels = rng.integers(-2, max_labels + 3, N).astype(np.int32)  # some dropped
    return vals, labels


@pytest.mark.parametrize("N,K,max_labels", [(3000, 16, 24), (5000, 3, 256), (2049, 1, 1)])
def test_segment_sum_matmul_matches_pallas_kernel(N, K, max_labels):
    vals, labels = _segment_inputs(N, K, max_labels, seed=N)
    assert (labels <= 0).any() and (labels > max_labels).any()
    want = np.asarray(jax_segment_sum_auto(jnp.asarray(vals), jnp.asarray(labels), max_labels))
    for fn in (segsum.segment_sum_matmul_plain, segsum.segment_sum_matmul, segsum.segment_sum_auto):
        got = fn(torch.from_numpy(vals), torch.from_numpy(labels), max_labels)
        assert got.shape == (max_labels, K) and got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy()[:, -1], want[:, -1])  # counts exact
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)
    # as per-label sums of the image-shaped form, int64 labels
    img = segsum.segment_sum_matmul(torch.from_numpy(vals).reshape(-1, 1, K),
                                    torch.from_numpy(labels).to(torch.int64).reshape(-1, 1),
                                    max_labels)
    assert torch.equal(img, got)


def test_segment_sum_matmul_non_finite_stays_in_its_label():
    vals, labels = _segment_inputs(2048, 2, 8, seed=1)
    labels = np.clip(labels, 0, 8)
    vals[5, 0], labels[5] = np.inf, 3
    vals[9, 0], labels[9] = np.nan, 6
    want = np.asarray(jax_segment_sum_auto(jnp.asarray(vals), jnp.asarray(labels), 8))
    got = segsum.segment_sum_matmul(torch.from_numpy(vals), torch.from_numpy(labels), 8).numpy()
    assert np.isnan(want[:, 0]).all()  # the matmul's 0 x inf: every label of the column
    assert got[2, 0] == np.inf and np.isnan(got[5, 0])
    assert np.isfinite(np.delete(got[:, 0], [2, 5])).all()
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-4, atol=1e-3)


def test_segment_sum_matmul_validation():
    with pytest.raises(ValueError):
        segsum.segment_sum_matmul(torch.zeros(7, 2), torch.zeros(4, dtype=torch.int32), 3)
    with pytest.raises(TypeError):
        segsum.segment_sum_matmul(torch.zeros(4, 2), torch.zeros(4), 3)


# The sum kernels' order on the CPU (``*_chunked``): a fold from +0.0 over
# each CHUNK-pixel chunk in pixel order, then over the chunk sums in chunk
# order. The CUDA kernels are held bit-equal to it on the card
# (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).

def _kernel_order_numpy(vals, bins, n_bins):
    """The kernel's order written out with numpy's in-order ``np.add.at``."""
    B, N, K = vals.shape
    out = np.zeros((B, n_bins, K), np.float32)
    for c0 in range(0, N, segsum.CHUNK):
        part = np.zeros((B, n_bins, K), np.float32)
        for b in range(B):
            sl = bins[b, c0:c0 + segsum.CHUNK]
            ok = (sl >= 0) & (sl < n_bins)
            np.add.at(part[b], sl[ok], vals[b, c0:c0 + segsum.CHUNK][ok])
        out = out + part
    return out


def _same_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    nan = np.isnan(got)
    np.testing.assert_array_equal(nan, np.isnan(want))
    np.testing.assert_array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32))


def _chunked_inputs(B, N, K, n_bins, seed):
    rng = np.random.default_rng(seed)
    vals = (rng.normal(0, 2, (B, N, K)) * 10.0 ** rng.integers(-3, 4, (B, N, K))).astype(
        np.float32)
    vals[..., -1] = 1.0
    bins = rng.integers(-2, n_bins + 2, (B, N)).astype(np.int32)
    bins[:, : N // 3] = rng.integers(0, min(n_bins, 3), (B, N // 3))  # long runs
    return vals, bins


@pytest.mark.parametrize("B,N,K,n_bins", [(2, 3 * 4096 + 123, 3, 17), (1, 2 * 4096, 6, 1),
                                          (3, 4096 + 1, 17, 257), (1, 5 * 4096 - 7, 2, 2176)])
def test_chunked_sums_are_the_kernel_order(B, N, K, n_bins):
    vals, bins = _chunked_inputs(B, N, K, n_bins, seed=N + K)
    got = segsum.binned_sum_cols_batched_chunked(torch.from_numpy(vals), torch.from_numpy(bins),
                                                 n_bins)
    _same_bits(got.numpy(), _kernel_order_numpy(vals, bins, n_bins))


@pytest.mark.parametrize("B,N,K,n_bins", [(2, 3 * 4096 + 123, 3, 17), (3, 4096 + 1, 17, 257),
                                          (1, 5 * 4096 - 7, 2, 2176)])
def test_chunked_sums_within_the_f32_bound(B, N, K, n_bins):
    """Against the plain (index_add_) sums: within 2 (n - 1) eps sum|t|, the
    bound on two f32 orders of the same n terms; against a float64 sum:
    within (n - 1) eps sum|t|. Counts exact."""
    vals, bins = _chunked_inputs(B, N, K, n_bins, seed=N)
    v, b = torch.from_numpy(vals), torch.from_numpy(bins)
    got = segsum.binned_sum_cols_batched_chunked(v, b, n_bins).numpy().astype(np.float64)
    plain = segsum.binned_sum_cols_batched_plain(v, b, n_bins).numpy().astype(np.float64)
    f64 = segsum.binned_sum_cols_batched_plain(v.double(), b, n_bins).numpy()
    mag = segsum.binned_sum_cols_batched_plain(v.abs().double(), b, n_bins).numpy()
    n = mag[..., -1:]  # the count column
    eps = 2.0 ** -23
    np.testing.assert_array_equal(got[..., -1], f64[..., -1])
    assert (np.abs(got - f64) <= np.maximum(n - 1, 0) * eps * mag).all()
    assert (np.abs(got - plain) <= 2 * np.maximum(n - 1, 0) * eps * mag).all()


def test_skipping_absent_chunks_changes_no_bit():
    """The kernels' second fold skips the chunks in which a bin has no
    pixel. Neither fold from +0.0 makes -0.0, so the skipped +0.0 is the
    identity: the sparse fold has the dense fold's bits, with -0.0, +-inf
    and NaN among the values."""
    rng = np.random.default_rng(3)
    B, N, K, n_bins = 2, 6 * 4096 + 50, 4, 40
    vals = rng.normal(0, 1, (B, N, K)).astype(np.float32)
    bins = rng.integers(0, n_bins, (B, N)).astype(np.int32)
    bins[:, :4096][bins[:, :4096] >= 20] -= 20  # bins 20.. miss the first chunk
    bins[:, 3 * 4096:4 * 4096][bins[:, 3 * 4096:4 * 4096] < 10] += 10  # bins ..9 miss the 4th
    vals[bins == 5] = -0.0  # a bin of -0.0 only
    vals[:, 100, 1], vals[:, 9000, 2], vals[:, 20000, 3] = np.inf, -np.inf, np.nan
    vals[0, 5000, 0], vals[1, 5000, 0] = np.inf, -0.0
    dense = segsum.binned_sum_cols_batched_chunked(torch.from_numpy(vals),
                                                   torch.from_numpy(bins), n_bins).numpy()
    sparse = np.zeros((B, n_bins, K), np.float32)
    for c0 in range(0, N, segsum.CHUNK):
        sl = slice(c0, c0 + segsum.CHUNK)
        part = segsum.binned_sum_cols_batched_plain(torch.from_numpy(vals[:, sl]),
                                                    torch.from_numpy(bins[:, sl]),
                                                    n_bins).numpy()
        present = np.zeros((B, n_bins), bool)
        for b in range(B):
            present[b, np.unique(bins[b, sl])] = True
        assert not (np.signbit(part) & (part == 0)).any()  # no chunk sum is -0.0
        sparse = np.where(present[..., None], sparse + part, sparse)
    assert (~np.isnan(dense)).any() and np.isnan(dense).any() and np.isinf(dense).any()
    assert (dense[:, 5] == 0).all() and not np.signbit(dense[:, 5]).any()
    _same_bits(sparse, dense)


@pytest.mark.parametrize("N,K,max_labels", [(3 * 4096 + 5, 16, 24), (4096, 3, 1)])
def test_segment_sum_chunked_is_the_kernel_order(N, K, max_labels):
    vals, labels = _segment_inputs(N, K, max_labels, seed=N)
    got = segsum.segment_sum_matmul_chunked(torch.from_numpy(vals), torch.from_numpy(labels),
                                            max_labels)
    want = _kernel_order_numpy(vals[None], labels[None] - 1, max_labels)[0]
    _same_bits(got.numpy(), want)


@pytest.mark.parametrize("B,N,K,n_bins", [(16, 65536, 6, 16705), (1, 1080 * 1080, 6, 66049),
                                          (16, 65536, 32, 65), (1, 1, 1, 2**31 - 1)])
def test_sum_scratch_follows_the_input(B, N, K, n_bins):
    """The sum kernels' scratch: a row of K sums, a bin and a list entry for
    each possible run (at most min(CHUNK, n_bins) a chunk), so no more rows
    than B x (N + CHUNK - 1) and than the first kernel's dense B x n_chunks x
    n_bins partial; then a few words per chunk and per (image, bin)."""
    n_f, n_i, n_l = segsum.sum_scratch_sizes(B, N, K, n_bins)
    n_chunks = -(-N // segsum.CHUNK)
    rows = n_f // K
    assert n_f == rows * K and rows <= B * (N + segsum.CHUNK - 1)
    assert rows <= B * n_chunks * n_bins and n_l <= rows
    assert n_f + n_i + 2 * n_l <= rows * (K + 4) + B * n_chunks + 4 * B * n_bins + 2


# ---------------------------------------------------------------------------
# zero pixels: plain's tables on every device (the card returns them without
# a launch; tests/test_torch_kernels_cuda.py pins that side)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,K,n_bins", [(1, 1, 1), (3, 5, 17)])
def test_zero_pixels_give_plain_tables(B, K, n_bins):
    """The JAX package's scatter sums and min/max do not take N = 0 (their
    reshape to (0, -1) raises), so the contract is plain's own: zero sums,
    (+inf, -inf) min/max; the lookup gives an empty result, as the JAX
    gather does."""
    vals = torch.zeros(B, 0, K)
    bins = torch.zeros(B, 0, dtype=torch.int32)
    sums = segsum.binned_sum_cols_batched(vals, bins, n_bins)
    assert sums.shape == (B, n_bins, K) and sums.dtype == torch.float32
    assert torch.equal(sums, torch.zeros(B, n_bins, K))
    mn, mx = segsum.binned_minmax_batched(vals, bins, n_bins)
    assert torch.equal(mn, torch.full((B, n_bins, K), float("inf")))
    assert torch.equal(mx, torch.full((B, n_bins, K), float("-inf")))
    table = np.random.default_rng(B).normal(size=(B, 4, K)).astype(np.float32)
    got = segsum.table_lookup_batched(torch.from_numpy(table), bins)
    want = jax.vmap(R.table_lookup)(jnp.asarray(table), jnp.zeros((B, 0), jnp.int32))
    assert got.shape == want.shape == (B, 0, K) and got.dtype == torch.float32
    image_bins = torch.zeros(B, 0, 7, dtype=torch.int32)  # image-shaped, one side empty
    assert segsum.table_lookup_batched(torch.from_numpy(table), image_bins).shape == (B, 0, 7, K)
    assert torch.equal(binned_sum_cols(vals, bins, n_bins), torch.zeros(B, n_bins, K))
