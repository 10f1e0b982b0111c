"""Port parity: the U-Net (``aliby_tpu_torch.models.unet.CellposeNet``) and
its weights (``aliby_tpu_torch.models.weights``) against the Flax model.

Tolerances:
- f32 on both sides: rtol 1e-4, atol 1e-4 (convolution sums in another
  order; GroupNorm statistics follow Flax's E[x^2]-E[x]^2).
- bf16 on both sides: the two frameworks round to bf16 at slightly
  different points (XLA:CPU's bf16 convolution and pooling against
  oneDNN's), and one-ulp bf16 differences (2^-8 relative) compound over
  the 26 convolutions. Stated bound: max |diff| <= 0.05 x max |ref| and
  mean |diff| <= 0.005 x max |ref|; the style vector within 2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import serialization

from aliby_tpu.models.training import load_params
from aliby_tpu.models.unet import init_params
from aliby_tpu_torch.models.unet import CellposeNet
from aliby_tpu_torch.models.weights import (
    BUNDLED_WEIGHTS,
    msgpack_restore,
    params_from_flax,
    read_flax_checkpoint,
)

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def field():
    return np.random.default_rng(0).normal(0, 1, (2, 32, 48, 2)).astype(np.float32)


def _torch_model(params, dtype):
    model = CellposeNet(dtype=dtype)
    model.load_state_dict(params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    return model.eval()


def _compare(got, want, kind):
    if kind == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        scale = np.abs(want).max()
        diff = np.abs(got - want)
        assert diff.max() <= 0.05 * scale, (diff.max(), scale)
        assert diff.mean() <= 0.005 * scale, (diff.mean(), scale)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_cellposenet_init_params(field, kind):
    jdt, tdt = DTYPES[kind]
    model, params = init_params(jax.random.PRNGKey(1), in_channels=2, size=32, dtype=jdt)
    want = np.asarray(model.apply(params, jnp.asarray(field)))
    want_style = np.asarray(model.apply(params, jnp.asarray(field), style_only=True))
    tm = _torch_model(params, tdt)
    with torch.no_grad():
        got = tm(torch.from_numpy(field)).numpy()
        got_style = tm(torch.from_numpy(field), style_only=True).numpy()
    assert got.shape == want.shape == (2, 32, 48, 3) and got.dtype == np.float32
    _compare(got, want, kind)
    np.testing.assert_allclose(got_style, want_style, atol=1e-5 if kind == "f32" else 2e-3)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_cellposenet_bundled_weights(field, kind):
    jdt, tdt = DTYPES[kind]
    model, template = init_params(jax.random.PRNGKey(0), in_channels=2, size=32, dtype=jdt)
    params = load_params(BUNDLED_WEIGHTS, template)
    want = np.asarray(model.apply(params, jnp.asarray(field)))
    tm = CellposeNet(dtype=tdt)
    tm.load_state_dict(params_from_flax(read_flax_checkpoint(BUNDLED_WEIGHTS)))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(field)).numpy()
    _compare(got, want, kind)


def test_msgpack_reader_matches_flax():
    data = BUNDLED_WEIGHTS.read_bytes()
    ours = jax.tree_util.tree_leaves_with_path(msgpack_restore(data))
    ref = jax.tree_util.tree_leaves_with_path(serialization.msgpack_restore(data))
    assert len(ours) == len(ref) == 134
    for (pa, a), (pb, b) in zip(ours, ref):
        assert pa == pb and a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # the other msgpack types flax can write
    tree = {"i": 7, "neg": -40, "big": 2**40, "s": "x" * 40, "l": [1.5, None, True],
            "scalar": np.float32(2.5), "arr": np.arange(70000, dtype=np.int64).reshape(7, -1)}
    back = msgpack_restore(serialization.msgpack_serialize(tree))
    assert back["i"] == 7 and back["neg"] == -40 and back["big"] == 2**40
    assert back["s"] == "x" * 40 and back["l"] == [1.5, None, True] and back["scalar"] == 2.5
    np.testing.assert_array_equal(back["arr"], tree["arr"])


def test_params_from_flax_layouts():
    state = params_from_flax(read_flax_checkpoint(BUNDLED_WEIGHTS))
    raw = read_flax_checkpoint(BUNDLED_WEIGHTS)["params"]
    assert state["stem.weight"].shape == (32, 2, 3, 3)  # HWIO -> OIHW
    np.testing.assert_array_equal(
        state["down.1.0.proj.weight"].numpy(),
        raw["down1a"]["proj"]["kernel"].astype(np.float32).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        state["style.2.weight"].numpy(), raw["style2"]["kernel"].astype(np.float32).T)
    assert state["up.0.1.norm1.weight"].dtype == torch.float32  # f16 -> f32
    assert set(state) == set(CellposeNet().state_dict())


def test_nearest_upsample_is_jax_resize():
    x = np.random.default_rng(1).normal(size=(2, 5, 7, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 10, 14, 3), method="nearest"))
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)
