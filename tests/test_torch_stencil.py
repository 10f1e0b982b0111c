"""Port parity: the stencil loops (``aliby_tpu_torch.ops.stencil``) against
the JAX package's XLA loops and its Pallas kernels in interpreter mode.

- successor_prop: bit-equal (integer selects).
- diffuse_heat: rtol 1e-6. XLA:CPU turns the division by 9 into a multiply
  by the rounded reciprocal; the port divides (as its CUDA kernel does).
  On these fields that costs at most 4 ulp after 8 rounds, 6 after 13 and
  11 after 96 (7.2e-7 relative); with a reciprocal multiply in its place the
  port is bit-equal to the XLA loop, which pins every other operation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aliby_tpu.models import flows as FL
from aliby_tpu.ops.pallas_stencil import diffuse_heat as jax_diffuse_heat
from aliby_tpu.ops.pallas_stencil import successor_prop as jax_successor_prop
from aliby_tpu.test_data import render_dense_cells
from aliby_tpu_torch.ops import stencil as S
from test_ops_stencil import _random_successor_field

torch.set_num_threads(1)


@pytest.mark.parametrize("n_prop", [12, 17, 96])
def test_successor_prop_bit_equal(n_prop):
    rng = np.random.default_rng(0)
    H, W = 48, 96
    dcodes, keys = zip(*(_random_successor_field(rng, H, W) for _ in range(3)))
    dcode, key = np.stack(dcodes), np.stack(keys)
    xla = jax.vmap(lambda d, k: FL._propagate_keys(n_prop, 6)(d, k))(
        jnp.asarray(dcode), jnp.asarray(key)
    )
    pallas = jax_successor_prop(
        jnp.asarray(dcode), jnp.asarray(key), n_prop=n_prop, block=6, interpret=True
    )
    got = S.successor_prop(torch.from_numpy(dcode), torch.from_numpy(key), n_prop=n_prop)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(xla))
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


def test_successor_prop_block_sizes_agree():
    rng = np.random.default_rng(5)
    dcode, key = (torch.from_numpy(a)[None] for a in _random_successor_field(rng, 40, 40))
    ref = S.successor_prop(dcode, key, n_prop=30, block=6)
    for block in (1, 4, 5):
        assert torch.equal(S.successor_prop(dcode, key, n_prop=30, block=block), ref)
    with pytest.raises(ValueError):
        S.successor_prop(dcode, key, n_prop=30, block=7)


def _labels_and_sources():
    rng = np.random.default_rng(1)
    labels = np.stack([render_dense_cells(64, 12, rng) for _ in range(2)]).astype(np.int32)
    src = jax.vmap(lambda l: FL.label_median_centers(l, 64).astype(jnp.float32))(
        jnp.asarray(labels)
    )
    return labels, np.array(src)


def _ulp(a, b):
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64)).max())


@pytest.mark.parametrize("n_iter", [8, 13, 96])
def test_diffuse_heat_matches_reference(n_iter):
    labels, src = _labels_and_sources()
    xla = np.asarray(jax.vmap(lambda l, s: FL._diffuse(n_iter)(l, s))(
        jnp.asarray(labels), jnp.asarray(src)))
    pallas = np.asarray(jax_diffuse_heat(
        jnp.asarray(labels), jnp.asarray(src), n_iter=n_iter, interpret=True))
    got = S.diffuse_heat(torch.from_numpy(labels), torch.from_numpy(src), n_iter).numpy()
    np.testing.assert_allclose(got, xla, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got, pallas, rtol=1e-6, atol=1e-7)
    assert _ulp(got, xla) <= 11
    assert got.max() > 0


def test_diffuse_heat_bit_equal_with_reciprocal_division(monkeypatch):
    """With the division by 9 replaced by XLA's reciprocal multiply, the
    plain version reproduces the XLA loop bit for bit."""
    labels, src = _labels_and_sources()
    xla = np.asarray(jax.vmap(lambda l, s: FL._diffuse(13)(l, s))(
        jnp.asarray(labels), jnp.asarray(src)))
    recip = torch.tensor(1 / 9, dtype=torch.float32)
    monkeypatch.setattr(S.torch, "div", lambda a, b: a * recip)
    got = S.diffuse_heat_plain(torch.from_numpy(labels), torch.from_numpy(src), 13).numpy()
    np.testing.assert_array_equal(got, xla)


def test_wrappers_validate_inputs():
    x = torch.zeros(1, 4, 4, dtype=torch.int32)
    with pytest.raises(TypeError):
        S.successor_prop(x.to(torch.int64), x)
    with pytest.raises(ValueError):
        S.diffuse_heat(x[0], x[0].float())
    with pytest.raises(TypeError):
        S.diffuse_heat(x, x)


# ---------------------------------------------------------------------------
# the exactness premise of the successor_prop kernel: the early-exited loops
# equal a loop that runs all n rounds, and so does successor-map doubling
# ---------------------------------------------------------------------------


def _cycle_field(rng, H, W, cycle):
    """A random clipped field with 2- or 3-cycles planted on a grid of spots."""
    dcode, key = _random_successor_field(rng, H, W)
    for y in range(1, H - 2, 5):
        for x in range(1, W - 2, 5):
            if cycle == 2:  # (y, x) -> (y, x + 1) -> (y, x)
                dcode[y, x], dcode[y, x + 1] = 5, 3
            else:  # (y, x) -> (y, x + 1) -> (y + 1, x) -> (y, x)
                dcode[y, x], dcode[y, x + 1], dcode[y + 1, x] = 5, 6, 1
    return dcode, key


def _unclipped_field(rng, H, W):
    """dcode in [-2, 11): border successors leave the grid, and values
    outside [0, 9) (and 4) stay."""
    dcode = rng.integers(-2, 11, (H, W)).astype(np.int32)
    key = rng.integers(1, 2**31 - 1, (H, W)).astype(np.int32)
    return dcode, key


def _fields():
    rng = np.random.default_rng(11)
    fields = [_cycle_field(rng, 24, 40, 2), _cycle_field(rng, 24, 40, 3),
              _unclipped_field(rng, 24, 40)]
    return [np.stack(a) for a in zip(*fields)]


def _all_rounds(dcode, key, n):
    """n rounds of key <- key[succ], no exit; 0 off the grid."""
    B, H, W = key.shape
    yi, xi = np.mgrid[0:H, 0:W]
    d = np.where((dcode < 0) | (dcode > 8), 4, dcode)
    sy, sx = yi + d // 3 - 1, xi + d % 3 - 1
    inside = (sy >= 0) & (sy < H) & (sx >= 0) & (sx < W)
    b = np.arange(B)[:, None, None]
    for _ in range(n):
        key = np.where(inside, key[b, sy.clip(0, H - 1), sx.clip(0, W - 1)], 0).astype(np.int32)
    return key


def _doubling(dcode, key, n):
    """The kernel's plan in numpy: S_1 from dcode (-1 off the grid), S_2m =
    S_m o S_m, the powers of n's binary digits composed as they are made,
    then out = key0 o S_n (0 where it left the grid)."""
    if n == 0:
        return key
    B, H, W = key.shape
    yi, xi = np.mgrid[0:H, 0:W]
    d = np.where((dcode < 0) | (dcode > 8), 4, dcode)
    sy, sx = yi + d // 3 - 1, xi + d % 3 - 1
    P = np.where((sy >= 0) & (sy < H) & (sx >= 0) & (sx < W), sy * W + sx, -1).reshape(B, -1)
    A = None
    b = np.arange(B)[:, None]

    def compose(M, X):  # M o X, -1 absorbing
        return np.where(X < 0, -1, M[b, X.clip(0)])

    for k in range(n.bit_length()):
        if (n >> k) & 1:
            A = P if A is None else compose(P, A)
        P = compose(P, P)
    flat = key.reshape(B, -1)
    return np.where(A < 0, 0, flat[b, A.clip(0)]).reshape(B, H, W)


@pytest.mark.parametrize("block", [1, 4, 6])
@pytest.mark.parametrize("n", [0, 1, 5, 17, 96, 97])
def test_early_exit_equals_all_rounds(n, block):
    dcode, key = _fields()
    want = _all_rounds(dcode, key, n)
    xla = jax.vmap(lambda d, k: FL._propagate_keys(n, block)(d, k))(
        jnp.asarray(dcode), jnp.asarray(key))
    np.testing.assert_array_equal(np.asarray(xla), want)
    plain = S.successor_prop_plain(torch.from_numpy(dcode), torch.from_numpy(key), n, block)
    np.testing.assert_array_equal(plain.numpy(), want)
    if block == 6:  # the kernel's arithmetic: the plan does not depend on block
        np.testing.assert_array_equal(_doubling(dcode, key, n), want)
    # every field reaches a fixed point before 96 rounds (the early exit fires)
    # and the unclipped one sends keys off the grid (zeros appear)
    if n >= 17:
        assert (want == 0).any()


def test_successor_prop_rejects_negative_rounds():
    x = torch.zeros(1, 4, 4, dtype=torch.int32)
    with pytest.raises(ValueError):
        S.successor_prop(x, x, n_prop=-1)


@pytest.mark.parametrize("n_iter", [0, 1, 8, 9, 10])
def test_diffuse_heat_border_label_and_few_rounds(n_iter):
    """A label touching all four borders, a background pixel inside it and a
    second label: the plain version against the XLA loop (rtol 1e-6, the
    division above) at the kernel's launch boundaries (9 rounds a launch)."""
    labels = np.ones((1, 20, 28), np.int32)
    labels[0, 5:9, 6:12] = 2
    labels[0, 14, 20] = 0
    src = np.zeros(labels.shape, np.float32)
    src[0, 10, 3], src[0, 6, 8] = 5.0, 2.0
    xla = np.asarray(jax.vmap(lambda l, s: FL._diffuse(n_iter)(l, s))(
        jnp.asarray(labels), jnp.asarray(src)))
    got = S.diffuse_heat(torch.from_numpy(labels), torch.from_numpy(src), n_iter).numpy()
    np.testing.assert_allclose(got, xla, rtol=1e-6, atol=1e-7)
    assert got[0, 14, 20] == 0 and (n_iter == 0) == (got.max() == 0)


def test_division_by_nine_with_two_fmas_is_correctly_rounded():
    """The diffusion kernel's division (stencil.cu div9_nonneg):
    q0 = RN(a * RN(1/9)), then RN(q0 + RN(a - 9 q0) * RN(1/9)), both FMAs
    exact before their one rounding, against the correctly rounded a / 9,
    for every float from +0.0 up to 2^-122 (subnormal quotients included)
    and every significand of [1, 2): above 2^-122 nothing under- or
    overflows, so the sequence scales with a's binade. Emulated in float64,
    where each product and sum here is exact (at most 53 significant bits);
    the float64 quotient rounded to float32 is the correctly rounded one
    (53 >= 2 * 24 + 2 bits: double rounding is innocuous for a quotient)."""
    inv9 = np.float64(np.float32(1) / np.float32(9))
    starts = [0] + [int(np.float32(2.0**e).view(np.uint32)) for e in (-126, -125, -124, -123, 0)]
    for first in starts:
        for chunk in range(0, 2**23, 2**21):
            bits = np.arange(first + chunk, first + chunk + 2**21, dtype=np.uint32)
            a = bits.view(np.float32).astype(np.float64)
            q0 = (a * inv9).astype(np.float32).astype(np.float64)
            r = a - 9.0 * q0
            assert np.array_equal(r.astype(np.float32).astype(np.float64), r)  # r is a float
            q = (q0 + r * inv9).astype(np.float32)
            np.testing.assert_array_equal(q.view(np.uint32),
                                          (a / 9.0).astype(np.float32).view(np.uint32))
