"""Port parity: jump-flooding distance transforms (``aliby_tpu_torch.ops.edt``)
against ``aliby_tpu.ops.edt`` on touching objects, square and ragged fields.

Tolerance: bit-equal (the squared distances are exact small integers in
f32, and the stride schedule, edge padding and tie rule are the
reference's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aliby_tpu.ops import edt as J
from aliby_tpu.test_data import render_dense_cells
from aliby_tpu_torch.ops import edt as T

torch.set_num_threads(1)


def _labels(H, W):
    rng = np.random.default_rng(H)
    out = np.stack([render_dense_cells(96, 25, rng, 3.0, 9.0)[:H, :W] for _ in range(2)])
    return out.astype(np.int32)


@pytest.fixture(scope="module", params=[(96, 96), (61, 83)], ids=["square", "ragged"])
def labels(request):
    return _labels(*request.param)


def test_edt_to_other_label(labels):
    want = np.asarray(jax.vmap(J.edt_to_other_label)(jnp.asarray(labels)))
    got = T.edt_to_other_label(torch.from_numpy(labels)).numpy()
    assert want.max() > 2
    np.testing.assert_array_equal(got, want)


def test_edt_and_nearest_seed():
    labels = _labels(61, 83)  # one field shape: one XLA compile per shape and function
    mask = labels > 0
    np.testing.assert_array_equal(T.edt(torch.from_numpy(mask)).numpy(),
                                  np.asarray(jax.vmap(J.edt)(jnp.asarray(mask))))
    seeds = (labels % 7 == 1) & mask
    got = T.nearest_seed(torch.from_numpy(seeds))
    want = jax.vmap(J.nearest_seed)(jnp.asarray(seeds))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    same = T.edt_to_seed_same_label(torch.from_numpy(seeds), torch.from_numpy(labels)).numpy()
    np.testing.assert_array_equal(
        same, np.asarray(jax.vmap(J.edt_to_seed_same_label)(jnp.asarray(seeds),
                                                            jnp.asarray(labels))))
