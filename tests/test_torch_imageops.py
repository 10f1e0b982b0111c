"""Port parity: exact order statistics and percentiles
(``aliby_tpu_torch.ops.imageops`` vs ``aliby_tpu.ops.imageops``), bit-equal.

XLA:CPU flushes subnormal arithmetic to zero; the percentile lerp is
compared with PyTorch's flush-to-zero on, so the subnormal cases compare
like with like (the order statistics themselves are bit-equal either way).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aliby_tpu.ops import imageops as I
from aliby_tpu_torch.ops import imageops as T

torch.set_num_threads(1)


def _cases():
    # the cases of test_ops_imageops.py::test_order_statistics_exact_vs_sort
    rng = np.random.default_rng(11)
    cases = []
    for n in (5, 64, 65, 1000, 4096):
        cases.append(rng.normal(0, 1, n).astype(np.float32))
        cases.append(rng.integers(-4, 4, n).astype(np.float32))  # duplicates
        cases.append(np.full(n, rng.normal(), np.float32))  # constant
        cases.append(rng.normal(0, 1e-38, n).astype(np.float32))  # subnormals
    cases.append(np.array([0.0, -0.0, -0.0, 0.0, 1.0, -1.0], np.float32))  # signed zeros
    cases.append(np.array([2.0, np.nan, -1.0, np.nan, 0.5, 7.0, -3.0], np.float32))
    return rng, cases


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def test_order_statistics_bit_equal():
    rng, cases = _cases()
    for x in cases:
        n = x.size
        ranks = tuple(sorted({0, n - 1, n // 2, int(rng.integers(0, n))}))
        want = np.asarray(I.order_statistics(x, ranks))
        got = T.order_statistics(torch.from_numpy(x), ranks).numpy()
        assert np.array_equal(_bits(want), _bits(got)), (n, ranks)


def test_order_statistics_batched_rows():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (3, 2, 500)).astype(np.float32)
    got = T.order_statistics(torch.from_numpy(x), (0, 7, 499)).numpy()
    assert got.shape == (3, 2, 3)
    for i in range(3):
        for j in range(2):
            want = np.asarray(I.order_statistics(x[i, j], (0, 7, 499)))
            assert np.array_equal(_bits(want), _bits(got[i, j]))


def test_nan_selects_as_plus_huge():
    x = np.array([1.0, np.nan, -0.0, 0.0, 3.0, np.nan, np.inf], np.float32)
    got = T.order_statistics(torch.from_numpy(x), tuple(range(7))).numpy()
    want = np.asarray(I.order_statistics(x, tuple(range(7))))
    assert np.array_equal(_bits(want), _bits(got))
    # -0.0 below +0.0, +inf below NaN, the NaNs last
    assert np.signbit(got[0]) and got[0] == 0 and not np.signbit(got[1])
    assert got[4] == np.inf and np.isnan(got[5]) and np.isnan(got[6])


@pytest.mark.parametrize("q", [(1.0, 99.0), (0.0, 100.0), (25.0, 50.0)])
def test_percentile_pair_bit_equal(q):
    _, cases = _cases()
    flush = torch.set_flush_denormal(True)
    try:
        for x in cases:
            lo, hi = I.percentile_pair(jnp.asarray(x), *q)
            tlo, thi = T.percentile_pair(torch.from_numpy(x), *q)
            assert _bits(lo) == _bits(tlo.numpy()), (x.size, q)
            assert _bits(hi) == _bits(thi.numpy()), (x.size, q)
    finally:
        if flush:
            torch.set_flush_denormal(False)


def test_sqrt_is_correctly_rounded():
    """PyTorch's CPU f32 ``sqrt`` is off by one ulp on some inputs (sqrt(267)
    among them); ``_sqrt`` rounds as XLA does (and the card)."""
    x = np.arange(1, 20000, dtype=np.float32)
    x = np.concatenate([x, np.random.default_rng(4).random(20000).astype(np.float32) * 3])
    want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(jnp.sqrt(x)), want)
    np.testing.assert_array_equal(T._sqrt(torch.from_numpy(x)).numpy(), want)
    assert torch.sqrt(torch.tensor([267.0])).item() != float(want[266])
