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
