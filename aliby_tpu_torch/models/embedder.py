"""In-process deep embedder, the replacement for a remote ``nahual_embed``
(counterpart of ``aliby_tpu/models/embedder.py``).

The ``style`` embedder is the flagship U-Net's encoder: the crop's global
style vector (its bottleneck summary, L2-normalised), from the bundled
trained weights, optionally projected to ``dim`` by a fixed random
projection. The closure consumes the crop tiler's ``(F, C, Z, ts, ts)``
pixel block and returns a raw ``(F, dim)`` f32 array, which the profile
assembly turns into ``X_<c>`` columns.

The projection is the JAX package's draw,
``jax.random.normal(PRNGKey(seed + 1), (bottleneck, dim)) / sqrt(bottleneck)``,
made here in numpy: threefry2x32 in JAX's partitionable layout (the same
bits), the uniform in ``[nextafter(-1, 0), 1)`` (the same floats), and
``sqrt(2) * erfinv(u)`` by XLA's f32 polynomial for ``erf_inv`` (within 3
ulp of JAX's normals: ``log1p`` differs in the last bits).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from aliby_tpu_torch.device import resolve_device

# ---------------------------------------------------------------------------
# JAX's random normals, in numpy
# ---------------------------------------------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry2x32(key: tuple[int, int], x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 with 20 rounds (Random123), JAX's ``threefry2x32_p``."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, np.uint32(k0 ^ k1 ^ np.uint32(0x1BD11BDA)))
    with np.errstate(over="ignore"):
        x0 = (x0 + ks[0]).astype(np.uint32)
        x1 = (x1 + ks[1]).astype(np.uint32)
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = (x0 + x1).astype(np.uint32)
                x1 = _rotl(x1, r) ^ x0
            x0 = (x0 + ks[(i + 1) % 3]).astype(np.uint32)
            x1 = (x1 + ks[(i + 2) % 3] + np.uint32(i + 1)).astype(np.uint32)
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` as its two uint32 words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed >> 32, seed & 0xFFFFFFFF


def random_bits(key: tuple[int, int], shape: tuple[int, ...]) -> np.ndarray:
    """32 random bits an element, as ``jax.random.bits`` with
    ``jax_threefry_partitionable``: the element's flat index as two words
    (high, low) through threefry, the two outputs xor-ed."""
    idx = np.arange(int(np.prod(shape)), dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    a, b = threefry2x32(key, hi, lo)
    return (a ^ b).reshape(shape)


def uniform(key: tuple[int, int], shape: tuple[int, ...], minval: float, maxval: float):
    """``jax.random.uniform`` in f32: 23 random mantissa bits under
    exponent 0, minus 1, scaled to ``[minval, maxval)``."""
    bits = random_bits(key, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)
    lo, hi = np.float32(minval), np.float32(maxval)
    return np.maximum(lo, (floats * (hi - lo) + lo).astype(np.float32))


_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: np.ndarray) -> np.ndarray:
    """XLA's f32 ``erf_inv`` (Giles' polynomials in w = -log1p(-x^2)); each
    Horner step one rounding, as an FMA; +-1 -> +-inf."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore"):  # |x| = 1: w = inf, the result set below
        w = (-np.log1p((-(x.astype(np.float64) * x)).astype(np.float32))).astype(np.float32)
    small = w < np.float32(5)
    w = np.where(small, w - np.float32(2.5), np.sqrt(w) - np.float32(3)).astype(np.float32)
    coef = [np.where(small, np.float32(a), np.float32(b)).astype(np.float32)
            for a, b in zip(_ERFINV_SMALL, _ERFINV_LARGE)]
    p = coef[0]
    for c in coef[1:]:
        p = (c.astype(np.float64) + p.astype(np.float64) * w).astype(np.float32)
    out = (p * x).astype(np.float32)
    return np.where(np.abs(x) == 1, np.copysign(np.float32(np.inf), x), out)


def normal(seed: int, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.normal(jax.random.PRNGKey(seed), shape)`` in f32."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    u = uniform(prng_key(seed), shape, lo, 1.0)
    return (np.float32(np.sqrt(2)) * erfinv_f32(u)).astype(np.float32)


def style_projection(seed: int, bottleneck: int, dim: int) -> np.ndarray:
    """The embedder's (bottleneck, dim) projection for ``seed``."""
    return (normal(seed + 1, (bottleneck, dim)) / np.float32(np.sqrt(bottleneck))).astype(
        np.float32)


# ---------------------------------------------------------------------------
# the embedder
# ---------------------------------------------------------------------------


def make_embedder(model: str = "style", dim: int | None = None,
                  channels: list[int] | None = None, seed: int = 0,
                  pretrained: str | bool = True, device=None, **kwargs):
    """(F, C, Z, Y, X) crops (a leading T of 1 dropped) -> (F, dim) f32
    style embeddings on ``device`` (``cuda`` unless ``device="cpu"``): the
    z max, then the net's two input channels as the first channel and the
    mean of the rest. Weights: the bundled flagship checkpoint, a flax
    checkpoint at ``pretrained``, or (``pretrained=True`` with a custom
    ``model_kwargs`` architecture) the net's seeded initialisation."""
    if model != "style":
        raise ValueError(f"Unknown embedder model {model!r} (in-process: 'style')")
    from aliby_tpu_torch.models.unet import CellposeNet
    from aliby_tpu_torch.models.weights import (
        BUNDLED_WEIGHTS,
        params_from_flax,
        read_flax_checkpoint,
    )

    device = resolve_device(device)
    model_kwargs = dict(kwargs.get("model_kwargs") or {})
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        net = CellposeNet(in_channels=2, **model_kwargs)
    weights_path = BUNDLED_WEIGHTS if pretrained is True else pretrained
    if pretrained is True and model_kwargs:
        weights_path = None  # a custom architecture cannot take the bundled checkpoint
    if weights_path and Path(weights_path).exists():
        net.load_state_dict(params_from_flax(read_flax_checkpoint(weights_path)))
    elif pretrained is not True and pretrained:
        raise FileNotFoundError(f"Embedder weights not found: {pretrained}")
    net.to(device).eval()

    bottleneck = net.feats[-1]
    proj = None
    if dim is not None and dim != bottleneck:
        proj = torch.from_numpy(style_projection(seed, bottleneck, dim)).to(device)

    def embed(pixels, **_ignored) -> np.ndarray:
        pixels = np.asarray(pixels, np.float32)
        if pixels.ndim == 6:
            pixels = pixels[0]
        if channels is not None:
            pixels = pixels[:, channels]
        imgs = pixels.max(axis=2) if pixels.shape[2] > 1 else pixels[:, :, 0]
        main = imgs[:, 0]
        rest = imgs[:, 1:].mean(axis=1) if imgs.shape[1] > 1 else np.zeros_like(main)
        x = torch.from_numpy(np.ascontiguousarray(np.stack([main, rest], axis=-1))).to(device)
        with torch.no_grad():
            style = net(x, style_only=True)
            if proj is not None:
                style = style @ proj
        return style.cpu().numpy()

    return embed
