"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips (with a reason) where no CUDA device is
present, as on a CPU-only test host. On a GPU machine without JAX or
pytest-xdist (``tests/conftest.py`` imports JAX) run, from the repo root,
``python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

from aliby_tpu_torch.extract.reductions import binned_sum_cols
from aliby_tpu_torch.models.flows import label_median_centers
from aliby_tpu_torch.ops import segsum, stencil

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _successors(rng, B, H, W):
    fy, fx = rng.uniform(-1, 1, (2, B, H, W)).astype(np.float32)
    yi, xi = np.mgrid[0:H, 0:W]
    dy = np.clip(np.round(np.clip(yi + fy, 0, H - 1)).astype(np.int32) - yi, -1, 1)
    dx = np.clip(np.round(np.clip(xi + fx, 0, W - 1)).astype(np.int32) - xi, -1, 1)
    key = np.broadcast_to((yi * W + xi).astype(np.int32), (B, H, W)).copy()
    return ((dy + 1) * 3 + (dx + 1)).astype(np.int32), key


@pytest.mark.parametrize("shape", [(4, 64, 64), (3, 200, 312), (1, 33, 31)])
@pytest.mark.parametrize("n_prop", [5, 17, 96])
def test_successor_prop_kernel_bit_equal(dev, shape, n_prop):
    d, k = (torch.from_numpy(a).to(dev) for a in _successors(np.random.default_rng(0), *shape))
    before = stencil.successor_prop.launches
    got = stencil.successor_prop(d, k, n_prop=n_prop)
    assert stencil.successor_prop.launches > before
    assert torch.equal(got, stencil.successor_prop_plain(d, k, n_prop=n_prop))


@pytest.mark.parametrize("shape", [(4, 64, 64), (3, 200, 312)])
def test_diffuse_heat_kernel_bit_equal(dev, shape):
    from aliby_tpu_torch.test_data import render_cells

    B, H, W = shape
    rng = np.random.default_rng(1)
    labels = np.stack([render_cells(max(H, W), 12, rng)[2][:H, :W] for _ in range(B)])
    lab = torch.from_numpy(labels.astype(np.int32)).to(dev)
    src = label_median_centers(lab, 64).to(torch.float32)
    got = stencil.diffuse_heat(lab, src, 96)
    assert torch.equal(got, stencil.diffuse_heat_plain(lab, src, 96))


@pytest.mark.parametrize("n_bins,K", [(1, 1), (257, 3), (1500, 8)])
def test_binned_sum_kernel(dev, n_bins, K):
    rng = np.random.default_rng(2)
    vals = torch.from_numpy(rng.normal(size=(3, 50000, K)).astype(np.float32)).to(dev)
    vals[..., -1] = 1.0
    bins = torch.from_numpy(rng.integers(-2, n_bins + 2, (3, 50000)).astype(np.int32)).to(dev)
    got = segsum.binned_sum_cols_batched(vals, bins, n_bins)
    want = segsum.binned_sum_cols_batched_plain(vals, bins, n_bins)
    assert torch.equal(got, segsum.binned_sum_cols_batched(vals, bins, n_bins))
    assert torch.equal(got[..., -1], want[..., -1])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))


def test_binned_sum_non_finite_on_device(dev):
    vals = torch.ones(1, 100, 2, device=dev)
    vals[0, 3, 0] = float("inf")
    bins = (torch.arange(100, device=dev) % 4).to(torch.int32)[None]
    out = binned_sum_cols(vals, bins, 4)
    assert torch.isnan(out[0, 3]).all() and torch.isfinite(out[0, :3]).all()
