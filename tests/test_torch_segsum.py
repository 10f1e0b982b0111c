"""Port parity: per-bin column sums (``aliby_tpu_torch.ops.segsum`` and
``aliby_tpu_torch.extract.reductions.binned_sum_cols``).

Tolerance: counts exact; sums rtol 1e-5 (f32 sums taken in another order).

Bins outside [0, n_bins) add nothing, as in the Pallas kernel; the JAX
package's CPU scatter wraps a negative bin to n_bins + bin instead (the
segmentation path never makes one).

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
from aliby_tpu.ops.pallas_segsum import binned_sum_cols_batched as jax_binned_sum
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
