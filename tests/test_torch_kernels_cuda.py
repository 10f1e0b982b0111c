"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips (with a reason) where no CUDA device is
present, as on a CPU-only test host. On a GPU machine without JAX or
pytest-xdist (``tests/conftest.py`` imports JAX) run, from the repo root,
``python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch
from fill_cases import FILL_CASES, pattern_label_maps, ring

from aliby_tpu_torch.extract.reductions import binned_sum_cols
from aliby_tpu_torch.models.flows import label_median_centers
from aliby_tpu_torch.ops import labels as label_ops
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
@pytest.mark.parametrize("n_prop", [0, 1, 5, 17, 96, 97])
def test_successor_prop_kernel_bit_equal(dev, shape, n_prop):
    d, k = (torch.from_numpy(a).to(dev) for a in _successors(np.random.default_rng(0), *shape))
    before = stencil.successor_prop.launches
    got = stencil.successor_prop(d, k, n_prop=n_prop)
    assert stencil.successor_prop.launches == before + n_prop.bit_length()
    assert torch.equal(got, stencil.successor_prop_plain(d, k, n_prop=n_prop))


@pytest.mark.parametrize("n_prop", [0, 1, 5, 17, 96, 97])
def test_successor_prop_kernel_unclipped_field(dev, n_prop):
    """Successors that leave the grid (key 0 there) and dcodes outside
    [0, 9) (they stay), as no main-path field has them."""
    rng = np.random.default_rng(n_prop)
    d = torch.from_numpy(rng.integers(-3, 12, (3, 67, 45)).astype(np.int32)).to(dev)
    k = torch.from_numpy(rng.integers(1, 2**31 - 1, (3, 67, 45)).astype(np.int32)).to(dev)
    got = stencil.successor_prop(d, k, n_prop=n_prop)
    want = stencil.successor_prop_plain(d, k, n_prop=n_prop)
    assert torch.equal(got, want)
    assert n_prop < 17 or (want == 0).any()


def _heat_inputs(rng, B, H, W, dev):
    from aliby_tpu_torch.test_data import render_cells

    labels = np.stack([render_cells(max(H, W), 12, rng)[2][:H, :W] for _ in range(B)])
    lab = torch.from_numpy(labels.astype(np.int32)).to(dev)
    return lab, label_median_centers(lab, 64).to(torch.float32)


@pytest.mark.parametrize("n_iter", [0, 1, 8, 9, 10, 96])
def test_diffuse_heat_kernel_round_counts(dev, n_iter):
    """Round counts around the kernel's 9 rounds a launch, on a ragged field
    smaller than two tiles and on one smaller than a tile."""
    for shape in ((2, 100, 77), (1, 33, 31)):
        lab, src = _heat_inputs(np.random.default_rng(n_iter), *shape, dev)
        before = stencil.diffuse_heat.launches
        got = stencil.diffuse_heat(lab, src, n_iter)
        assert stencil.diffuse_heat.launches == before + stencil.diffuse_launches(n_iter)
        assert torch.equal(got, stencil.diffuse_heat_plain(lab, src, n_iter))


def test_diffuse_heat_kernel_border_label_and_infinity(dev):
    """A label touching all four borders, background holes, a second label,
    and sources holding +inf (on a foreground and a background pixel): the
    same bits as plain, NaN positions equal (inf * 0 spreads NaN)."""
    labels = np.ones((2, 60, 71), np.int32)
    labels[:, 10:25, 10:40] = 2
    labels[:, 45, 60] = 0
    labels[1, 0, :] = 0
    lab = torch.from_numpy(labels).to(dev)
    src = label_median_centers(lab, 64).to(torch.float32)
    for n_iter in (9, 96):
        got = stencil.diffuse_heat(lab, src, n_iter)
        assert torch.equal(got, stencil.diffuse_heat_plain(lab, src, n_iter))
    edges = (got[0, 0, :], got[0, -1, :], got[0, :, 0], got[0, :, -1])
    assert all((e > 0).any() for e in edges)
    src[0, 30, 35] = float("inf")
    src[1, 45, 60] = float("inf")
    for n_iter in (9, 96):
        got = stencil.diffuse_heat(lab, src, n_iter)
        want = stencil.diffuse_heat_plain(lab, src, n_iter)
        assert torch.isnan(want).any()
        assert _same_bits(got, want)


def test_stencils_launches_per_call_and_no_host_sync(dev):
    """At the main path's 96 rounds: successor_prop 7 launches (<= 8),
    diffuse_heat 12 (<= 13), with no host synchronisation inside either
    call and nothing else on the device (no memset)."""
    d, k = (torch.from_numpy(a).to(dev) for a in _successors(np.random.default_rng(3), 4, 64, 64))
    lab, src = _heat_inputs(np.random.default_rng(3), 4, 64, 64, dev)
    stencil.successor_prop(d, k)
    stencil.diffuse_heat(lab, src)  # built and loaded before the sync check
    torch.cuda.synchronize()
    before = stencil.successor_prop.launches, stencil.diffuse_heat.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        stencil.successor_prop(d, k, n_prop=96)
        stencil.diffuse_heat(lab, src, 96)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    n_prop = stencil.successor_prop.launches - before[0]
    n_heat = stencil.diffuse_heat.launches - before[1]
    assert n_prop == 7 <= 8 and n_heat == 12 <= 13
    for fn, names in ((lambda: stencil.successor_prop(d, k), ("succ_square", "succ_gather")),
                      (lambda: stencil.diffuse_heat(lab, src),
                       ("diffuse_flags", "diffuse_rounds"))):
        events = _device_kernels(fn)
        assert all(any(n in key for n in names) for key in events), events


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


def _ragged_fill_cases():
    """Random blobs and rings at shapes that fill no block of the bounds
    kernel evenly, label values past 2^30 and below 0 among them."""
    rng = np.random.default_rng(11)
    out = []
    for H, W in ((100, 77), (31, 33), (1, 50), (97, 1), (257, 130)):
        blobs = (rng.random((3, H, W)) < 0.5) * rng.choice([-2, 1, 2, 256, 2**30, 2**30 + 3],
                                                              (3, H, W))
        rings = np.maximum(ring(H, W, H // 2, W // 3, 14, 5, 4),
                           ring(H, W, H // 3, W // 2, 9, 3, 9))
        out.append(np.concatenate([blobs.astype(np.int32), rings[None]]))
    return out


@pytest.mark.parametrize("case", ["ragged", *FILL_CASES])
def test_fill_label_holes_kernel_bit_equal(dev, case):
    batches = _ragged_fill_cases() if case == "ragged" else [FILL_CASES[case]()]
    for labels in batches:
        lab = torch.from_numpy(labels)
        before = label_ops.fill_label_holes.launches
        got = label_ops.fill_label_holes(lab.to(dev))
        assert label_ops.fill_label_holes.launches == before + label_ops.FILL_LAUNCHES == before + 5
        assert torch.equal(got.cpu(), label_ops.fill_label_holes_plain(lab))


def test_fill_label_holes_kernel_on_plate_maps(dev):
    """A call's batch at the benchmark's shape: 9 fields x (nuclei, cells)
    of 1080^2, bit-equal to the plain version on the card."""
    lab = torch.from_numpy(pattern_label_maps()).to(dev)
    got = label_ops.fill_label_holes(lab)
    want = label_ops.fill_label_holes_plain(lab)
    assert torch.equal(got, want)
    assert (want != lab).any()  # the punched holes are filled


def test_fill_label_holes_rejects_what_the_kernel_does_not_take(dev):
    lab = torch.zeros(2, 40, 40, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        label_ops.fill_label_holes(lab.to(torch.int64))
    with pytest.raises(ValueError):
        label_ops.fill_label_holes(lab[0])
    with pytest.raises(ValueError):
        label_ops.fill_label_holes(lab.transpose(1, 2))


def test_fill_label_holes_launches_and_no_host_sync(dev):
    """Five launches a call, no host synchronisation inside it, and nothing
    on the device but the five kernels (no memset)."""
    lab = torch.from_numpy(_ragged_fill_cases()[0]).to(dev)
    label_ops.fill_label_holes(lab)  # built and loaded before the sync check
    torch.cuda.synchronize()
    before = label_ops.fill_label_holes.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        label_ops.fill_label_holes(lab)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert label_ops.fill_label_holes.launches - before == label_ops.FILL_LAUNCHES
    events = _device_kernels(lambda: label_ops.fill_label_holes(lab))
    assert all("hole_" in key for key in events), events


def test_masks_from_flows_on_the_card_fills_through_the_kernel(dev):
    """masks_from_flows on a CUDA batch: fill_label_holes.launches rises by
    the fixed count, and the labels are those of the plain fill on the
    same unfilled labels."""
    from aliby_tpu_torch.models import flows

    gt = torch.from_numpy(pattern_label_maps(n_fields=1, size=256, cells=40)).to(dev)
    fl = flows.masks_to_flows(gt)
    cellprob = torch.where(gt > 0, 4.0, -4.0)
    before = label_ops.fill_label_holes.launches
    got = flows.masks_from_flows(fl, cellprob, flow_threshold=0.4)
    assert label_ops.fill_label_holes.launches == before + label_ops.FILL_LAUNCHES
    unfilled = flows.masks_from_flows(fl, cellprob, flow_threshold=0.4, fill_holes=False)
    assert torch.equal(got, label_ops.fill_label_holes_plain(unfilled))


@pytest.mark.parametrize("n_bins,K", [(1, 1), (257, 3), (1500, 8), (65, 17), (257, 32)])
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
    assert _same_bits(got, segsum.binned_sum_cols_batched_chunked(vals.cpu(), bins.cpu(), n_bins))


def _same_bits(a, b):
    """The same bits at every position, NaN positions equal (any payload)."""
    a, b = a.cpu(), b.cpu()
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a[~nan].view(torch.int32), b[~nan].view(torch.int32))


def _sum_inputs(rng, B, H, W, K, n_bins, layout):
    """(B, H*W, K) values with +-inf and NaN here and there and a count
    column, and (B, H*W) int32 bins, some negative or past n_bins. ``labels``:
    bins as the feature bank lays them out, contiguous objects (tiled
    synthetic label maps) times 257 sub-bins where n_bins holds them;
    ``uniform``: uniform random bins."""
    from aliby_tpu_torch.test_data import render_cells

    N = H * W
    if layout == "labels":
        sub = 257 if n_bins > 257 and n_bins % 257 == 0 else 1
        n_obj = n_bins // sub
        maps = []
        for _ in range(B):
            lab = render_cells(256, 24, rng)[2]
            lab = np.tile(lab, (-(-H // 256), -(-W // 256)))[:H, :W].astype(np.int64)
            maps.append((lab % n_obj) * sub + rng.integers(0, sub, (H, W)))
        bins = np.stack(maps).reshape(B, N)
    else:
        bins = rng.integers(0, n_bins, (B, N))
    bins[rng.random((B, N)) < 0.01] = -1
    bins[rng.random((B, N)) < 0.005] = n_bins + 7
    bins[:, :3] = (-5, n_bins, 0)
    vals = rng.normal(size=(B, N, K)).astype(np.float32)
    vals[..., -1] = 1.0
    for v in (np.inf, -np.inf, np.nan):
        vals[rng.integers(0, B), rng.integers(3, N), rng.integers(0, K)] = v
    return (torch.from_numpy(vals).to("cuda"),
            torch.from_numpy(bins.astype(np.int32)).to("cuda"))


@pytest.mark.parametrize("layout", ["labels", "uniform"])
@pytest.mark.parametrize("n_bins,K", [(1, 1), (65, 17), (65, 32), (257, 3), (16705, 6),
                                      (66049, 6)])
def test_binned_sum_kernel_bit_equal_to_chunked(dev, n_bins, K, layout):
    """The sums have the bits of the kernel's order taken on the CPU (a
    ragged N, dropped bins, +-inf and NaN included) and the same bits on
    two runs."""
    vals, bins = _sum_inputs(np.random.default_rng(n_bins + K), 3, 257, 259, K, n_bins, layout)
    got = segsum.binned_sum_cols_batched(vals, bins, n_bins)
    again = segsum.binned_sum_cols_batched(vals, bins, n_bins)
    want = segsum.binned_sum_cols_batched_chunked(vals.cpu(), bins.cpu(), n_bins)
    assert got.shape == (3, n_bins, K)
    assert _same_bits(got, again)
    assert _same_bits(got, want)


def test_binned_sum_kernel_one_bin_and_one_pixel_per_bin(dev):
    """Every pixel in one bin (the longest run, 4,096 adds a chunk), and
    every pixel in a bin of its own among 66,049."""
    rng = np.random.default_rng(12)
    N = 66049 - 5
    vals = torch.from_numpy(rng.normal(size=(2, N, 6)).astype(np.float32)).to(dev)
    for bins in (torch.zeros(2, N, dtype=torch.int32, device=dev),
                 torch.from_numpy(np.stack([rng.permutation(66049)[:N]] * 2)
                                  .astype(np.int32)).to(dev)):
        got = segsum.binned_sum_cols_batched(vals, bins, 66049)
        want = segsum.binned_sum_cols_batched_chunked(vals.cpu(), bins.cpu(), 66049)
        assert _same_bits(got, want)


def test_binned_sum_non_finite_on_device(dev):
    vals = torch.ones(1, 100, 2, device=dev)
    vals[0, 3, 0] = float("inf")
    bins = (torch.arange(100, device=dev) % 4).to(torch.int32)[None]
    out = binned_sum_cols(vals, bins, 4)
    assert torch.isnan(out[0, 3]).all() and torch.isfinite(out[0, :3]).all()


def test_binned_sum_kernel_columns_ride_independently(dev):
    """A column's sums are the same bits whatever columns ride beside it
    (K = 17 and its first 3 columns take the same order)."""
    rng = np.random.default_rng(5)
    vals = torch.from_numpy(rng.normal(size=(2, 70000, 17)).astype(np.float32)).to(dev)
    bins = torch.from_numpy(rng.integers(0, 65, (2, 70000)).astype(np.int32)).to(dev)
    wide = segsum.binned_sum_cols_batched(vals, bins, 65)
    narrow = segsum.binned_sum_cols_batched(vals[..., :3].contiguous(), bins, 65)
    assert torch.equal(wide[..., :3], narrow)
    vals, bins = _sum_inputs(rng, 2, 256, 256, 17, 16705, "labels")
    wide = segsum.binned_sum_cols_batched(vals, bins, 16705)
    narrow = segsum.binned_sum_cols_batched(vals[..., :3].contiguous(), bins, 16705)
    assert _same_bits(wide[..., :3], narrow)


@pytest.mark.parametrize("N,K,max_labels", [(16 * 65536, 16, 256), (62407, 16, 256),
                                            (5000, 1, 1), (70000, 32, 1500)])
def test_segment_sum_kernel(dev, N, K, max_labels):
    """The unbatched per-label sums: counts exact, sums within rtol 1e-5 of
    the plain version, the same bits on two runs, dropped labels add nothing."""
    rng = np.random.default_rng(8)
    vals = torch.from_numpy(rng.normal(size=(N, K)).astype(np.float32)).to(dev)
    vals[:, -1] = 1.0
    labels = torch.from_numpy(rng.integers(-2, max_labels + 3, N).astype(np.int32)).to(dev)
    before = segsum.segment_sum_matmul.launches
    got = segsum.segment_sum_matmul(vals, labels, max_labels)
    assert segsum.segment_sum_matmul.launches == before + 1
    want = segsum.segment_sum_matmul_plain(vals, labels, max_labels)
    assert got.shape == (max_labels, K)
    assert torch.equal(got, segsum.segment_sum_auto(vals, labels.to(torch.int64), max_labels))
    assert torch.equal(got[:, -1], want[:, -1])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    assert torch.equal(got, segsum.segment_sum_matmul(vals, labels, max_labels))
    assert _same_bits(got, segsum.segment_sum_matmul_chunked(vals.cpu(), labels.cpu(),
                                                             max_labels))


@pytest.mark.parametrize("N,K,max_labels", [(16 * 65536, 16, 256), (66563, 6, 66049),
                                            (66563, 17, 65), (4096 * 3 + 1, 32, 1)])
def test_segment_sum_kernel_bit_equal_to_chunked(dev, N, K, max_labels):
    """Label-map labels (label 0 dropped), dropped labels, +-inf and NaN:
    the bits of the kernel's order on the CPU, the same bits on two runs."""
    vals, bins = _sum_inputs(np.random.default_rng(N + K), 1, -(-N // 512), 512, K,
                             max_labels + 1, "labels")
    vals, labels = vals[0, :N].contiguous(), bins[0, :N].contiguous()
    got = segsum.segment_sum_matmul(vals, labels, max_labels)
    assert _same_bits(got, segsum.segment_sum_matmul(vals, labels, max_labels))
    assert _same_bits(got, segsum.segment_sum_matmul_chunked(vals.cpu(), labels.cpu(),
                                                             max_labels))


def test_sum_kernels_over_a_thousand_chunks(dev):
    """An image of more than 1,024 chunks: each bin's rows are ranked in
    windows of 1,024 chunks; the bits stay those of the kernel's order."""
    rng = np.random.default_rng(13)
    N = 4096 * 1100 + 5
    vals = torch.from_numpy(rng.normal(size=(N, 2)).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(-1, 5, N).astype(np.int32)).to(dev)
    got = segsum.segment_sum_matmul(vals, labels, 3)
    assert _same_bits(got, segsum.segment_sum_matmul_chunked(vals.cpu(), labels.cpu(), 3))
    got = segsum.binned_sum_cols_batched(vals[None], labels[None], 4)
    assert _same_bits(got, segsum.binned_sum_cols_batched_chunked(vals[None].cpu(),
                                                                  labels[None].cpu(), 4))


def test_segment_sum_kernel_non_finite_and_limits(dev):
    vals = torch.ones(100, 2, device=dev)
    vals[3, 0] = float("inf")
    labels = (torch.arange(100, device=dev) % 4).to(torch.int32)
    out = segsum.segment_sum_matmul(vals, labels, 3)
    assert out[2, 0] == float("inf") and torch.isfinite(out[:2]).all() and out[2, 1] == 25
    with pytest.raises(ValueError):
        segsum.segment_sum_matmul(torch.ones(10, 33, device=dev), labels[:10], 3)


def test_binned_sum_cols_groups_past_32_columns(dev):
    """367 columns (the zernike pass's full width) go through the kernel in
    12 groups; a column's bits do not depend on its group."""
    rng = np.random.default_rng(9)
    vals = torch.from_numpy(rng.normal(size=(2, 40000, 367)).astype(np.float32)).to(dev)
    bins = torch.from_numpy(rng.integers(-1, 66, (2, 40000)).astype(np.int32)).to(dev)
    before = segsum.binned_sum_cols_batched.launches
    got = binned_sum_cols(vals, bins, 65)
    assert segsum.binned_sum_cols_batched.launches == before + 12
    want = segsum.binned_sum_cols_batched_plain(vals, bins, 65)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
    assert torch.equal(got[..., 40:50], binned_sum_cols(vals[..., 40:50].contiguous(), bins, 65))
    with pytest.raises(ValueError):
        segsum.binned_sum_cols_batched(vals, bins, 65)


def _minmax_inputs(rng, B, N, K, n_bins, dev):
    vals = rng.normal(size=(B, N, K)).astype(np.float32)
    vals[rng.random((B, N, K)) < 1e-4] = np.nan
    vals[0, 0, 0] = np.nan
    bins = rng.integers(-2, n_bins + 2, (B, N)).astype(np.int32)
    bins[0, 0] = 0
    return torch.from_numpy(vals).to(dev), torch.from_numpy(bins).to(dev)


def _equal_with_nan(a, b):
    return torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(
        torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0))


@pytest.mark.parametrize("B,N,K,n_bins", [(16, 65536, 2, 65), (4, 65536, 2, 257),
                                          (3, 62400, 1, 257), (2, 1000, 4, 1000)])
def test_binned_minmax_kernel(dev, B, N, K, n_bins):
    vals, bins = _minmax_inputs(np.random.default_rng(6), B, N, K, n_bins, dev)
    before = segsum.binned_minmax_batched.launches
    mn, mx = segsum.binned_minmax_batched(vals, bins, n_bins)
    assert segsum.binned_minmax_batched.launches == before + 1
    pmn, pmx = segsum.binned_minmax_batched_plain(vals, bins, n_bins)
    assert mn.shape == (B, n_bins, K) and torch.isnan(mn).any()
    assert _equal_with_nan(mn, pmn) and _equal_with_nan(mx, pmx)


def test_binned_minmax_empty_bins_and_budget(dev):
    vals = torch.ones(1, 10, 1, device=dev)
    bins = torch.zeros(1, 10, dtype=torch.int32, device=dev)
    mn, mx = segsum.binned_minmax_batched(vals, bins, 3)
    assert mn[0, 1:, 0].eq(float("inf")).all() and mx[0, 1:, 0].eq(float("-inf")).all()
    with pytest.raises(ValueError):
        segsum.binned_minmax_batched(torch.ones(1, 10, 2, device=dev), bins, 2049)


@pytest.mark.parametrize("B,N,L,K", [(16, 65536, 64, 3), (3, 62400, 256, 3), (2, 5000, 257, 1)])
def test_table_lookup_kernel(dev, B, N, L, K):
    rng = np.random.default_rng(7)
    table = rng.normal(size=(B, L, K)).astype(np.float32)
    table[0, 1, 0], table[-1, 2, K - 1], table[0, 3, 0] = np.inf, -np.inf, np.nan
    bins = rng.integers(-3, L + 3, (B, N)).astype(np.int32)
    t, b = torch.from_numpy(table).to(dev), torch.from_numpy(bins).to(dev)
    got = segsum.table_lookup_batched(t, b)
    want = segsum.table_lookup_batched_plain(t, b)
    assert got.shape == (B, N, K) and torch.isnan(got).any()
    assert _equal_with_nan(got, want)


# The redesigned min/max and lookup kernels on adversarial inputs: label
# images (objects on a background: the warp-aggregated case), every pixel in
# one bin, one pixel per bin, a ragged N (odd, N x K not a multiple of 4, one
# image and three), the limits n_bins x K = 4,096 and L x K = 12,288, +-inf,
# NaN and signed zeros. Min/max: equal to plain with NaN positions equal
# (torch.equal: -0.0 == +0.0; the signed-zero rule is pinned apart); the
# lookup, a copy: the same bits as plain.

def _label_maps(rng, B, N):
    """(B, N) int32: the test fields' label maps tiled to 256 x 256 (objects
    1..24 on the background 0), cut to N pixels."""
    from aliby_tpu_torch.test_data import render_cells

    base = [render_cells(256, 24, rng)[2].reshape(-1) for _ in range(4)]
    return np.stack([np.resize(base[i % 4], N) for i in range(B)]).astype(np.int32)


def _minmax_values(rng, B, N, K):
    v = rng.normal(0, 50, (B, N, K)).astype(np.float32)
    r = rng.random((B, N, K))
    v[r < 0.02] = 0.0
    v[(r >= 0.02) & (r < 0.04)] = -0.0
    v[r > 1 - 1e-4] = np.nan
    v[(r > 1 - 2e-4) & (r <= 1 - 1e-4)] = np.inf
    v[(r > 1 - 3e-4) & (r <= 1 - 2e-4)] = -np.inf
    return v


def _check_minmax(vals, bins, n_bins):
    v, b = torch.from_numpy(vals).to("cuda"), torch.from_numpy(bins).to("cuda")
    mn, mx = segsum.binned_minmax_batched(v, b, n_bins)
    pmn, pmx = segsum.binned_minmax_batched_plain(v, b, n_bins)
    assert mn.shape == mx.shape == (bins.shape[0], n_bins, vals.shape[-1])
    assert _equal_with_nan(mn, pmn) and _equal_with_nan(mx, pmx)


@pytest.mark.parametrize("layout", ["label images", "bbox coordinates", "one bin",
                                    "one pixel per bin"])
@pytest.mark.parametrize("K", [1, 2])
def test_binned_minmax_kernel_adversarial(dev, layout, K):
    rng = np.random.default_rng(K)
    B, N, n_bins = 16, 65536, 65
    vals = _minmax_values(rng, B, N, K)
    if layout == "one bin":
        bins = np.zeros((B, N), np.int32)
    elif layout == "one pixel per bin":
        B, N, n_bins = 2, 4096 // K, 4096 // K
        vals = vals[:B, :N]
        bins = np.stack([rng.permutation(N) for _ in range(B)]).astype(np.int32)
    else:
        bins = _label_maps(rng, B, N)
        bins[:, 5], bins[:, 9] = -1, n_bins  # dropped
    if layout == "bbox coordinates":  # rising with the pixel index
        yy, xx = np.mgrid[0:256, 0:256].astype(np.float32)
        vals = np.broadcast_to(np.stack([yy, xx], -1).reshape(1, N, 2)[..., :K],
                               (B, N, K)).copy()
    _check_minmax(vals, bins, n_bins)


@pytest.mark.parametrize("B,N,K,n_bins", [(1, 62401, 2, 65), (3, 62401, 3, 65),
                                          (3, 62401, 1, 257), (1, 62401, 1, 4096),
                                          (2, 65536, 2, 2048), (2, 65536, 4, 1024),
                                          (1, 7, 2, 3)])
def test_binned_minmax_kernel_ragged_and_limits(dev, B, N, K, n_bins):
    """A ragged N (odd: misaligned images at B 3), n_bins x K up to 4,096,
    and fewer pixels than a thread takes."""
    rng = np.random.default_rng(N + K)
    bins = _label_maps(rng, B, N) if n_bins == 65 else rng.integers(
        -2, n_bins + 2, (B, N)).astype(np.int32)
    _check_minmax(_minmax_values(rng, B, N, K), bins, n_bins)


def test_binned_minmax_kernel_signed_zeros(dev):
    """-0.0 counts as below +0.0: a bin holding both (in either order, in
    one warp or across blocks) gives min -0.0 and max +0.0, a bin of one
    sign that zero."""
    rng = np.random.default_rng(3)
    bins = _label_maps(rng, 16, 65536)
    neg = rng.random(bins.shape) < 0.5
    vals = np.where(neg, np.float32(-0.0), np.float32(0.0))[..., None]
    mn, mx = segsum.binned_minmax_batched(torch.from_numpy(vals).to(dev),
                                          torch.from_numpy(bins).to(dev), 65)
    mn, mx = mn.cpu()[..., 0].numpy(), mx.cpu()[..., 0].numpy()
    has_neg = np.zeros((16, 65), bool)
    has_pos = np.zeros((16, 65), bool)
    for i in range(16):
        has_neg[i, np.unique(bins[i][neg[i]])] = True
        has_pos[i, np.unique(bins[i][~neg[i]])] = True
    present = has_neg | has_pos
    assert (has_neg & has_pos).any()
    assert (mn[present] == 0).all() and (mx[present] == 0).all()
    np.testing.assert_array_equal(np.signbit(mn[present]), has_neg[present])
    np.testing.assert_array_equal(np.signbit(mx[present]), ~has_pos[present])
    pair = torch.tensor([[-0.0, 0.0, 0.0, -0.0]], device=dev)[..., None]
    mn, mx = segsum.binned_minmax_batched(pair, torch.tensor([[0, 0, 1, 1]], device=dev), 2)
    assert torch.signbit(mn).all() and not torch.signbit(mx).any()


def _device_kernels(fn, calls=5):
    """{name: launches recorded} of the device work (kernels, memsets) of
    ``calls`` calls of ``fn`` (torch.profiler; a short window may record
    only some launches, never more)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = {e.key: e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA}
    if not events:
        pytest.skip("the profiler saw no CUDA kernels")
    return events


def test_minmax_and_lookup_one_launch_per_call(dev):
    """One kernel a call and nothing else on the device: no init or decode
    kernel, no memset."""
    rng = np.random.default_rng(4)
    bins = torch.from_numpy(_label_maps(rng, 16, 65536)).to(dev)
    vals = torch.from_numpy(_minmax_values(rng, 16, 65536, 2)).to(dev)
    table = torch.from_numpy(rng.normal(size=(16, 65, 3)).astype(np.float32)).to(dev)
    for fn, counter, name in ((lambda: segsum.binned_minmax_batched(vals, bins, 65),
                               segsum.binned_minmax_batched, "binned_minmax_kernel"),
                              (lambda: segsum.table_lookup_batched(table, bins),
                               segsum.table_lookup_batched, "table_lookup_kernel")):
        before = counter.launches
        fn()
        assert counter.launches == before + 1
        events = _device_kernels(fn)
        assert len(events) == 1 and name in next(iter(events)), events
        assert 1 <= next(iter(events.values())) <= 5


def _lookup_table(rng, B, L, K):
    t = rng.normal(0, 10, (B, L, K)).astype(np.float32)
    t[0, 1, 0], t[-1, 2, K - 1], t[0, 3, K - 1], t[0, 4, 0] = np.inf, -np.inf, np.nan, -0.0
    return t


def _check_lookup(table, bins):
    t, b = torch.from_numpy(table).to("cuda"), torch.from_numpy(bins).to("cuda")
    got = segsum.table_lookup_batched(t, b)
    assert got.shape == bins.shape + (table.shape[-1],)
    assert _same_bits(got, segsum.table_lookup_batched_plain(t, b))


@pytest.mark.parametrize("K", [*range(1, 9), 13])
@pytest.mark.parametrize("B", [1, 3])
def test_table_lookup_kernel_every_width_ragged(dev, B, K):
    """Every K from 1 to 8 and 13 on a ragged N (odd: N x K not a multiple
    of 4, so images 1 and 2 start off a 16-byte boundary)."""
    rng = np.random.default_rng(10 * B + K)
    _check_lookup(_lookup_table(rng, B, 64, K),
                  rng.integers(-3, 67, (B, 62401)).astype(np.int32))


@pytest.mark.parametrize("layout", ["label images", "one bin", "one pixel per bin"])
@pytest.mark.parametrize("K", [3, 5])
def test_table_lookup_kernel_label_images(dev, layout, K):
    rng = np.random.default_rng(K)
    if layout == "label images":
        table, bins = _lookup_table(rng, 16, 64, K), _label_maps(rng, 16, 65536)
    elif layout == "one bin":
        table, bins = _lookup_table(rng, 16, 64, K), np.full((16, 65536), 4, np.int32)
    else:
        table = _lookup_table(rng, 2, 4096 // K, K)
        bins = np.stack([rng.permutation(4096 // K) for _ in range(2)]).astype(np.int32)
    _check_lookup(table, bins)


@pytest.mark.parametrize("L,K", [(12288, 1), (4096, 3), (1536, 8)])
def test_table_lookup_kernel_limits(dev, L, K):
    """L x K = 12,288: the table and the chunk's bins past 48 KB of shared
    memory; a wider table raises."""
    rng = np.random.default_rng(L)
    _check_lookup(_lookup_table(rng, 2, L, K),
                  rng.integers(-3, L + 3, (2, 65536)).astype(np.int32))
    with pytest.raises(ValueError):
        segsum.table_lookup_batched(torch.zeros(1, L + 1, K, device=dev),
                                    torch.zeros(1, 5, dtype=torch.int32, device=dev))


def test_sqrt_on_the_card_is_correctly_rounded(dev):
    from aliby_tpu_torch.ops.imageops import _sqrt

    x = np.concatenate([np.arange(1, 20000, dtype=np.float32),
                        np.random.default_rng(4).random(20000).astype(np.float32) * 3])
    want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(_sqrt(torch.from_numpy(x).to(dev)).cpu().numpy(), want)


def test_binned_minmax_on_two_streams(dev):
    """Overlapping calls on two streams, with different grids (G blocks per
    image) over the same image indices, each equal to plain: the tickets
    are kept per stream."""
    rng = np.random.default_rng(12)
    cases = [(16, 65536, 2, 65), (2, 1080 * 1080, 1, 257)]
    inputs = [_minmax_inputs(rng, *c, dev) for c in cases]
    assert len({segsum.minmax_scratch(B, N, K * n)[0] for B, N, K, n in cases}) == 2
    want = [segsum.binned_minmax_batched_plain(v, b, c[3]) for (v, b), c in zip(inputs, cases)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(20):
        for i, (s, (v, b), c) in enumerate(zip(streams, inputs, cases)):
            with torch.cuda.stream(s):
                outs[i].append(segsum.binned_minmax_batched(v, b, c[3]))
    torch.cuda.synchronize()
    for got, (pmn, pmx) in zip(outs, want):
        for mn, mx in got:
            assert _equal_with_nan(mn, pmn) and _equal_with_nan(mx, pmx)


@pytest.mark.parametrize("B,K,n_bins", [(1, 1, 1), (3, 5, 17)])
def test_zero_pixels_on_the_card(dev, B, K, n_bins):
    """N = 0: plain's tensors (zero sums, (+inf, -inf), an empty lookup),
    with no launch."""
    vals = torch.zeros(B, 0, K, device=dev)
    bins = torch.zeros(B, 0, dtype=torch.int32, device=dev)
    table = torch.ones(B, 4, K, device=dev)
    counters = (segsum.binned_sum_cols_batched, segsum.binned_minmax_batched,
                segsum.table_lookup_batched)
    before = [c.launches for c in counters]
    sums = segsum.binned_sum_cols_batched(vals, bins, n_bins)
    mn, mx = segsum.binned_minmax_batched(vals, bins, n_bins)
    got = segsum.table_lookup_batched(table, bins)
    assert [c.launches for c in counters] == before
    assert torch.equal(sums, segsum.binned_sum_cols_batched_plain(vals, bins, n_bins))
    pmn, pmx = segsum.binned_minmax_batched_plain(vals, bins, n_bins)
    assert torch.equal(mn, pmn) and torch.equal(mx, pmx) and mn.shape == (B, n_bins, K)
    assert got.shape == segsum.table_lookup_batched_plain(table, bins).shape == (B, 0, K)
    assert sums.is_cuda and mn.is_cuda and got.is_cuda


def _movie_labels(T=4, F=3, size=256, seed=2):
    """(T, F, Y, X) int32 label maps of drifting, appearing and vanishing cells."""
    from aliby_tpu_torch.test_data import cellpainting_movie

    movie = cellpainting_movie(F, T, size, seed=seed).astype(np.float32)
    labels = np.zeros((T, F, size, size), np.int32)
    for f in range(F):
        for t in range(T):
            fg = movie[f, t, 3, 0] > 0.3 * 4096
            # cut the foreground into 16-px blocks: many objects, some touching
            yy, xx = np.mgrid[0:size, 0:size]
            labels[t, f] = np.where(fg, 1 + (yy // 16) * (size // 16) + xx // 16, 0) % 250
    return labels


def test_stitch_movie_on_the_card_is_the_cpu_bits(dev):
    from aliby_tpu_torch.track.trackers import stitch_movie

    labels = _movie_labels()
    F = labels.shape[1]
    init = labels[0] * 3 + 1000 * (labels[0] > 0)  # carried globals far above max_labels
    init_max = init.reshape(F, -1).max(axis=1).astype(np.int32)
    for has in (False, True, torch.tensor([True, False, True])):
        args = (torch.from_numpy(labels[1:]), torch.from_numpy(init.astype(np.int32)),
                torch.from_numpy(init_max), has)
        want = stitch_movie(*args)
        got = stitch_movie(*(a.to(dev) if isinstance(a, torch.Tensor) else a for a in args))
        for g, w in zip(got, want):
            assert g.is_cuda and torch.equal(g.cpu(), w)


def test_chunk_tracking_makes_no_host_sync(dev):
    from aliby_tpu_torch.track.trackers import stitch_movie

    labels = torch.from_numpy(_movie_labels()).to(dev)
    zeros = torch.zeros_like(labels[0])
    zmax = torch.zeros(labels.shape[1], dtype=torch.int32, device=dev)
    before = segsum.binned_sum_cols_batched.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        g, m = stitch_movie(labels, zeros, zmax, False)
        g, m = stitch_movie(labels, g[-1], m[-1], True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # one intersection count a frame, every tile batched; the first frame of
    # each call also counts against the carry
    assert segsum.binned_sum_cols_batched.launches == before + 2 * labels.shape[0]
    assert int(m.min()) > 0


def test_intersection_count_against_plain(dev):
    """The trackers' intersection count at the main path's shape: 66,049
    bins, one column of ones; exact counts, equal to plain and to the
    kernel's order on the CPU."""
    rng = np.random.default_rng(5)
    prev = rng.integers(0, 257, (2, 540, 540)).astype(np.int32)
    cur = rng.integers(0, 257, (2, 540, 540)).astype(np.int32)
    bins = torch.from_numpy((prev * 257 + cur).reshape(2, -1)).to(dev)
    ones = torch.ones(bins.shape + (1,), device=dev)
    got = segsum.binned_sum_cols_batched(ones, bins, 257 * 257)
    assert torch.equal(got, segsum.binned_sum_cols_batched_plain(ones, bins, 257 * 257))
    assert torch.equal(got.cpu(), segsum.binned_sum_cols_batched_chunked(
        ones.cpu(), bins.cpu(), 257 * 257))
    assert float(got.sum()) == 2 * 540 * 540


def _virtual_tiles(dev, n_traps=12, size=117, seed=8):
    """The BABY overlap path's virtual tiles: each (trap, layer) of 3 layers
    is one 117 x 117 image (label k in layer k % 3, relabelled 1..n), many
    layers empty; values like fluorescence, a NaN in one cell."""
    from aliby_tpu_torch.test_data import render_cells

    rng = np.random.default_rng(seed)
    layers = []
    for t in range(n_traps):
        _, _, lab = render_cells(size, int(rng.integers(0, 3)), rng)
        for s in range(3):
            layer = np.where((lab > 0) & (lab % 3 == s), lab, 0)
            ids = np.unique(layer)[1:]
            seq = np.zeros(int(lab.max()) + 1, np.int32)
            seq[ids] = np.arange(1, len(ids) + 1)
            layers.append(seq[layer])
    labels = torch.from_numpy(np.stack(layers)).to(dev)
    vals = torch.from_numpy(rng.normal(2000, 300, labels.shape + (4,)).astype(np.float32)).to(dev)
    vals[0, 50, 50, 1] = float("nan")
    return labels, vals


def test_kernels_at_the_virtual_tile_shape(dev):
    """Kernels 3-5 at the overlap path's (3 x traps, 117 x 117) shape with
    empty layers: sums bit-equal to the kernel's order on the CPU, min/max
    equal to plain (NaN positions equal), the lookup bit-equal to plain;
    one launch a call for min/max and the lookup."""
    labels, vals = _virtual_tiles(dev)
    assert (labels.reshape(labels.shape[0], -1).amax(dim=1) == 0).any()
    n_bins = int(labels.max()) + 1
    got = segsum.binned_sum_cols_batched(vals, labels, n_bins)
    assert _same_bits(got, segsum.binned_sum_cols_batched_chunked(vals.cpu(), labels.cpu(),
                                                                  n_bins))
    before = segsum.binned_minmax_batched.launches
    mn, mx = segsum.binned_minmax_batched(vals[..., :2], labels, n_bins)
    assert segsum.binned_minmax_batched.launches == before + 1
    pmn, pmx = segsum.binned_minmax_batched_plain(vals[..., :2], labels, n_bins)
    assert _equal_with_nan(mn, pmn) and _equal_with_nan(mx, pmx)
    table = vals[:, :n_bins, 0, :2].contiguous()
    before = segsum.table_lookup_batched.launches
    out = segsum.table_lookup_batched(table, labels)
    assert segsum.table_lookup_batched.launches == before + 1
    assert _same_bits(out, segsum.table_lookup_batched_plain(table, labels))


def test_threshold_segmenter_and_cellfuns_on_the_card(dev):
    """The threshold segmenter gives the CPU's labels on the card (its blur,
    Otsu and EDT are elementwise in a fixed order), and the cellfuns
    metrics over them the CPU's within ``extract.tolerances`` (the CPU's
    sums in the kernel's order)."""
    from aliby_tpu_torch.extract import cellfuns
    from aliby_tpu_torch.extract.tolerances import beyond_tolerance
    from aliby_tpu_torch.models.segment import threshold_segment
    from aliby_tpu_torch.test_data import yeast_timelapse

    imgs = torch.from_numpy(yeast_timelapse(41, T=3, size=117)[:, 1].max(axis=1)
                            .astype(np.float32))
    got = threshold_segment(imgs.to(dev), threshold_scale=0.6)
    want = threshold_segment(imgs, threshold_scale=0.6)
    assert torch.equal(got.cpu(), want) and int(want.max()) > 3
    plain = segsum.binned_sum_cols_batched_plain
    segsum.binned_sum_cols_batched_plain = segsum.binned_sum_cols_batched_chunked
    try:
        cpu = {**cellfuns.mask_metrics(want, 32), **cellfuns.pixel_metrics(want, imgs, 32)}
    finally:
        segsum.binned_sum_cols_batched_plain = plain
    card = {**cellfuns.mask_metrics(got, 32), **cellfuns.pixel_metrics(got, imgs.to(dev), 32)}
    for k, w in cpu.items():
        w = w.numpy().astype(np.float64)
        bad = beyond_tolerance(k, card[k].cpu().numpy(), w,
                               lambda other: cpu.get(other, cpu[k]).numpy().astype(np.float64))
        assert not bad.any(), k


def _cpnet_checkpoint(tmp_path, nbase=(2, 32, 64, 128, 256)):
    from aliby_tpu_torch.test_data import cpnet_state_dict

    path = tmp_path / "cyto_seeded.pth"
    torch.save(cpnet_state_dict(0, nbase=nbase), path)
    return path


def test_cpnet_on_the_card_is_true_f32(dev, tmp_path):
    """The f32 CPnet forward on the card (cuDNN TF32 off inside, the global
    flag as the caller left it) within 2e-4 of max(1, scale) of the CPU's;
    the cpnet segmenter's labels bit-equal to the CPU's, or equal counts
    and matched IoU >= 0.99."""
    from aliby_tpu_torch.extract.tolerances import within_model_tolerance
    from aliby_tpu_torch.models.cpnet import load_cellpose_checkpoint
    from aliby_tpu_torch.models.segment import CellposeTorch
    from aliby_tpu_torch.test_data import cellpainting_fields
    from test_dynamics_parity import matched_iou

    path = _cpnet_checkpoint(tmp_path)
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (2, 96, 128, 2))
                         .astype(np.float32))
    cpu = load_cellpose_checkpoint(path)
    card = load_cellpose_checkpoint(path).to(dev)
    flag = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            got, got_style = card(x.to(dev))
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = flag
    with torch.no_grad():
        want, want_style = cpu(x)
    assert within_model_tolerance(got.cpu().numpy(), want.numpy(), "cpnet")
    assert within_model_tolerance(got_style.cpu().numpy(), want_style.numpy(), "cpnet")
    pix = np.concatenate(cellpainting_fields(2, 96, seed=7))
    imgs = np.stack([pix[:, 3, 0], pix[:, 0, 0]], 1).astype(np.float32)
    for ft in (0.4, None):
        kw = dict(pretrained_path=path, flow_threshold=ft)
        a = CellposeTorch(device=dev, **kw).segment_tiles(imgs)
        b = CellposeTorch(device="cpu", **kw).segment_tiles(imgs)
        for x_, y_ in zip(a, b):
            if not np.array_equal(x_, y_):
                assert x_.max() == y_.max()
                assert min(matched_iou(x_, y_), matched_iou(y_, x_)) >= 0.99


def test_cpnet_f32_on_several_threads(dev, tmp_path):
    """f32 CPnet forwards and cpnet segmenters on four threads at once, as
    ``run_positions``' workers and the server's connections run them: the
    bits of a forward run alone, and the caller's TF32 flag afterwards."""
    import threading

    from aliby_tpu_torch.models.cpnet import load_cellpose_checkpoint
    from aliby_tpu_torch.models.segment import CellposeTorch
    from aliby_tpu_torch.test_data import cellpainting_fields

    path = _cpnet_checkpoint(tmp_path)
    rng = np.random.default_rng(4)
    xs = [torch.from_numpy(rng.uniform(0, 1, (1, 256, 256, 2)).astype(np.float32)).to(dev)
          for _ in range(4)]
    pix = np.concatenate(cellpainting_fields(4, 128, seed=9))
    imgs = np.stack([pix[:, 3, 0], pix[:, 0, 0]], 1).astype(np.float32)
    model = load_cellpose_checkpoint(path).to(dev)
    kw = dict(pretrained_path=path, flow_threshold=None)
    flag = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        with torch.no_grad():
            alone = [model(x)[0].cpu() for x in xs]
        seg = CellposeTorch(device=dev, **kw)
        labels = [seg.segment_tiles(imgs[i:i + 1])[0] for i in range(4)]
        got, got_labels, errors = {}, {}, []
        start = threading.Barrier(4)

        def work(i):
            try:
                seg = CellposeTorch(device=dev, **kw)
                start.wait(30)
                for r in range(3):
                    with torch.no_grad():
                        got[i, r] = model(xs[i])[0].cpu()
                    got_labels[i, r] = seg.segment_tiles(imgs[i:i + 1])[0]
            except Exception as e:  # raised in the test's thread below
                errors.append(e)

        threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(300)
        assert not errors, errors
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = flag
    for (i, r), out in got.items():
        assert torch.equal(out, alone[i]), (i, r)
        assert np.array_equal(got_labels[i, r], labels[i]), (i, r)
    assert len(got) == 12 and all(m.max() > 0 for m in labels)


def test_spots_on_the_card_are_the_cpu_bits(dev):
    from aliby_tpu_torch.models.spots import detect_spots, paint_spots
    from aliby_tpu_torch.test_data import cellpainting_fields

    frames = torch.from_numpy(np.concatenate(cellpainting_fields(3, 160, seed=5))[:, 0, 0]
                              .astype(np.float32))
    for kw in ({}, {"max_spots": 16}):
        c, r, v = detect_spots(frames.to(dev), **kw)
        lab = paint_spots((160, 160), c, r, v)
        cc, rc, vc = detect_spots(frames, **kw)
        assert torch.equal(v.cpu(), vc) and vc.sum() > 10
        assert torch.equal(c.cpu()[vc], cc[vc]) and torch.equal(r.cpu()[vc], rc[vc])
        assert torch.equal(lab.cpu(), paint_spots((160, 160), cc, rc, vc))


def test_embedder_on_the_card(dev):
    from aliby_tpu_torch.extract.tolerances import within_model_tolerance
    from aliby_tpu_torch.models.embedder import make_embedder

    tiles = np.random.default_rng(2).normal(100, 20, (6, 5, 2, 64, 64)).astype(np.float32)
    embed = make_embedder(dim=64, device=dev)
    got = embed(tiles)
    assert np.array_equal(got, embed(tiles))
    assert within_model_tolerance(got, make_embedder(dim=64, device="cpu")(tiles), "embed")


def test_model_server_on_the_card(dev, tmp_path):
    """A server on the card answers a client as the model does in process."""
    from aliby_tpu_torch.models.segment import dispatch_segmenter
    from aliby_tpu_torch.net.client import make_remote_segmenter
    from aliby_tpu_torch.net.server import ModelServer
    from aliby_tpu_torch.test_data import cellpainting_fields

    pixels = np.concatenate(cellpainting_fields(2, 128, seed=3))
    with ModelServer(f"ipc://{tmp_path}/card.ipc", device=dev) as server:
        for kind in ("cellpose", "threshold", "spotiflow"):
            remote = make_remote_segmenter(f"nahual_{kind}", channel_to_segment=3,
                                           address=server.address)(pixels)
            local = dispatch_segmenter("spots" if kind == "spotiflow" else kind, 3,
                                       device=dev)(pixels)
            assert len(remote) == 2 and all(np.array_equal(a, b) for a, b in zip(remote, local))


def _train_run(dev, dtype, steps, batch=2, size=64, seed=0):
    """``steps`` train steps of the flagship at full width from
    ``init_params(seed)``, batches from ``default_rng(seed)``, a cosine
    schedule at 2e-3: (model, losses)."""
    from aliby_tpu_torch.models import training as T
    from aliby_tpu_torch.models.unet import init_params

    model = init_params(seed, device=dev, dtype=dtype)
    opt, scheduler = T.adamw(model.parameters(), T.cosine_decay_schedule(2e-3, steps, 0.05))
    step = T.make_train_step(model, opt, scheduler)
    rng = np.random.default_rng(seed)
    losses = [step(T.synthetic_batch(rng, batch, size, device=dev))["loss"] for _ in range(steps)]
    return model, torch.stack(losses)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_runs_on_the_card_give_the_same_bits(dev, dtype):
    a, loss_a = _train_run(dev, dtype, 3)
    b, loss_b = _train_run(dev, dtype, 3)
    assert torch.equal(loss_a, loss_b)
    for (name, x), y in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(x, y), name


def test_train_targets_on_the_card_and_no_host_sync(dev):
    """One batch's targets are one diffuse_heat call; the batch is the CPU's
    (images and fg bit-equal, flows within 1e-5); the step makes no host
    synchronisation once its batch is on the card."""
    from aliby_tpu_torch.models import training as T
    from aliby_tpu_torch.models.unet import init_params

    before = stencil.diffuse_heat.launches
    batch = T.synthetic_batch(np.random.default_rng(4), 3, 64, budding_frac=0.3, device=dev)
    assert stencil.diffuse_heat.launches == before + stencil.diffuse_launches(96)
    cpu = T.synthetic_batch(np.random.default_rng(4), 3, 64, budding_frac=0.3, device="cpu")
    assert torch.equal(batch["image"].cpu(), cpu["image"]) and torch.equal(batch["fg"].cpu(),
                                                                           cpu["fg"])
    assert (batch["flows"].cpu() - cpu["flows"]).abs().max() <= 1e-5
    model = init_params(0, device=dev)
    opt, scheduler = T.adamw(model.parameters(), 1e-3)
    step = T.make_train_step(model, opt, scheduler)
    step(batch)  # the first step allocates the optimizer's state
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        metrics = step(batch)
        metrics = step(batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(metrics["loss"]).item()


def test_f32_train_step_on_the_card_matches_the_cpu(dev):
    """One f32 step at full width on the card (TF32 off inside the step, the
    caller's flag kept) against the same step on the CPU: the loss within
    LOSS_RTOL, each gradient by ``gradient_excess`` at the card's limits."""
    from aliby_tpu_torch.extract.tolerances import (
        GRAD_CARD_FLOOR_ATOL,
        GRAD_CARD_RTOL,
        LOSS_RTOL,
        gradient_excess,
    )
    from aliby_tpu_torch.models import training as T
    from aliby_tpu_torch.models.unet import init_params

    batch = T.synthetic_batch(np.random.default_rng(2), 2, 64, device="cpu")
    out = {}
    flag = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for where in ("cpu", dev):
            model = init_params(0, device=where, dtype=torch.float32)
            seen = []
            model.register_forward_hook(lambda *a: seen.append(torch.backends.cudnn.allow_tf32))
            opt, scheduler = T.adamw(model.parameters(), 1e-3)
            grads = {}
            opt.register_step_pre_hook(lambda *a: grads.update(
                {n: p.grad.detach().cpu().numpy() for n, p in model.named_parameters()}))
            metrics = T.make_train_step(model, opt, scheduler)(
                {k: v.to(where) for k, v in batch.items()})
            out[str(where)] = (float(metrics["loss"]), grads, seen)
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = flag
    (loss_c, grads_c, _), (loss_g, grads_g, seen) = out["cpu"], out[str(dev)]
    assert seen == [False]
    np.testing.assert_allclose(loss_g, loss_c, rtol=LOSS_RTOL)
    excess = gradient_excess(grads_g, grads_c, GRAD_CARD_RTOL, GRAD_CARD_FLOOR_ATOL)
    worst = max(excess.items(), key=lambda kv: kv[1][0])
    print(f"f32 card vs CPU: loss rel {abs(loss_g - loss_c) / abs(loss_c):.3g}, worst gradient "
          f"{worst[0]} at {worst[1][0]:.3g} of its limit")
    assert worst[1][0] <= 1, worst


def test_every_kernel_on_a_second_card_from_a_thread_on_device_0(dev):
    """The C entries launch on the calling thread's current device: each
    wrapper makes its tensors' card current. Every kernel on ``cuda:1``,
    called from a thread whose current device is 0, equals its plain
    version (the sums: the kernel's order on the CPU), and the thread's
    current device is 0 again after each call."""
    import threading

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards (a launch on cuda:1 from a thread on device 0)")
    d1 = torch.device("cuda", 1)
    rng = np.random.default_rng(21)
    dcode, key = (torch.from_numpy(a).to(d1) for a in _successors(rng, 3, 200, 312))
    labels = torch.from_numpy(rng.integers(0, 6, (2, 130, 140)).astype(np.int32)).to(d1)
    source = torch.from_numpy(rng.random((2, 130, 140)).astype(np.float32)).to(d1)
    vals = torch.from_numpy(rng.normal(0, 1, (4, 9000, 32)).astype(np.float32)).to(d1)
    bins = torch.from_numpy(rng.integers(-1, 70, (4, 9000)).astype(np.int32)).to(d1)
    table = torch.from_numpy(rng.normal(0, 1, (4, 65, 3)).astype(np.float32)).to(d1)
    calls = {
        "successor_prop": lambda: stencil.successor_prop(dcode, key, n_prop=96),
        "diffuse_heat": lambda: stencil.diffuse_heat(labels, source, n_iter=96),
        "binned_sum_cols_batched": lambda: segsum.binned_sum_cols_batched(vals, bins, 65),
        "segment_sum_matmul": lambda: segsum.segment_sum_matmul(vals[0], bins[0], 64),
        "binned_minmax_batched": lambda: segsum.binned_minmax_batched(vals[..., :3], bins, 65),
        "table_lookup_batched": lambda: segsum.table_lookup_batched(table, bins),
    }
    got, seen = {}, []

    def work():
        torch.cuda.set_device(0)
        for name, call in calls.items():
            got[name] = call()
            seen.append(torch.cuda.current_device())
        torch.cuda.synchronize(d1)

    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=300)
    assert not t.is_alive() and len(got) == len(calls) and seen == [0] * len(calls)
    assert torch.equal(got["successor_prop"], stencil.successor_prop_plain(dcode, key, 96))
    assert torch.equal(got["diffuse_heat"], stencil.diffuse_heat_plain(labels, source, 96))
    assert torch.equal(got["binned_sum_cols_batched"].cpu(),
                       segsum.binned_sum_cols_batched_chunked(vals.cpu(), bins.cpu(), 65))
    assert torch.equal(got["segment_sum_matmul"].cpu(),
                       segsum.segment_sum_matmul_chunked(vals[0].cpu(), bins[0].cpu(), 64))
    for g, w in zip(got["binned_minmax_batched"],
                    segsum.binned_minmax_batched_plain(vals[..., :3], bins, 65)):
        assert _equal_with_nan(g, w)
    assert torch.equal(got["table_lookup_batched"],
                       segsum.table_lookup_batched_plain(table, bins))


def test_two_shards_on_one_card_give_the_one_device_bits(dev):
    """The dp-sharded fused step with both shards on one card (each in its
    own thread, on its own stream): labels and the feature block equal the
    one-device step's on the concatenated batch, the shared state widens
    with it, and each shard launched every main-path kernel."""
    from aliby_tpu_torch.engine import builders
    from aliby_tpu_torch.engine.compiled import try_compile
    from aliby_tpu_torch.engine.fused import ShardedStep
    from aliby_tpu_torch.test_data import cellpainting_fields

    pipeline = builders.build_pipeline_steps(
        channels_to_segment={"nuclei": 0, "cell": 3}, channels_to_extract=[0, 3],
        features_to_extract=("intensity", "sizeshape"),
        cp_measure_feature_kwargs={"intensity": {"edge_measurements": False}})
    pixels = np.concatenate(cellpainting_fields(4, 256, seed=7))
    fused = try_compile(pipeline, device=dev).fused
    fused.state.update(cap=16, u8=True)
    want = fused(pixels)
    want_state = dict(fused.state)
    sharded = ShardedStep([fused, fused])
    sharded.state.update(cap=16, u8=True)
    try:
        for _ in range(2):  # the second call reuses the shards' streams and tickets
            got = sharded([pixels[:3], pixels[3:]])
            torch.cuda.synchronize()
            for g, w in zip(got["labels"], want["labels"]):
                np.testing.assert_array_equal(g, w)
            for g_obj, w_obj in zip(got["features"], want["features"]):
                for (gn, ga), (wn, wa) in zip(g_obj, w_obj):
                    assert gn == wn and np.array_equal(ga, wa, equal_nan=True)
    finally:
        sharded.close()
    assert sharded.state == want_state and want_state["cap"] > 16
    for counts in sharded.shard_launches:
        assert all(counts.get(k, 0) > 0 for k in (
            "successor_prop", "diffuse_heat", "binned_sum_cols_batched",
            "binned_minmax_batched", "table_lookup_batched")), counts


def test_mesh_runner_with_a_lagging_shard_gives_the_dp1_bits(dev, tmp_path):
    """``run_positions_mesh_states`` on two shards of one card, where shard
    0's stream sleeps before each of its steps, so that its feature trees
    and tracking still run while the runner copies the next chunk's blocks:
    the profiles, labels and tracker states equal the dp = 1 run's (a block
    freed back to another stream's pool while a shard still reads it would
    be overwritten by that copy)."""
    from aliby_tpu_torch.engine import builders
    from aliby_tpu_torch.engine.compiled import try_compile_sharded
    from aliby_tpu_torch.engine.core import profile_columns
    from aliby_tpu_torch.engine.fused import ShardedStep
    from aliby_tpu_torch.io import zarrlite
    from aliby_tpu_torch.io.dataset import DatasetZarr
    from aliby_tpu_torch.parallel import pipeline_mesh
    from aliby_tpu_torch.parallel.mesh import make_mesh
    from aliby_tpu_torch.test_data import cellpainting_movie

    class Lagging(ShardedStep):
        def _in_shard(self, i, wait, fn, args):
            def late(*a):
                torch.cuda._sleep(100_000_000)  # ~50 ms on shard 0's stream
                return fn(*a)

            return super()._in_shard(i, wait, late if i == 0 else fn, args)

    def lagging(pipeline, devices):
        steps, sharded = try_compile_sharded(pipeline, devices)
        sharded.close()
        return steps, Lagging(sharded.runs)

    movie = cellpainting_movie(3, 4, 256, seed=12, n_cells=20)
    for p in range(3):
        zarrlite.write_array(tmp_path / "store" / f"pos{p}", movie[p],
                             chunks=(1, 1, 1, 256, 256))
    positions = DatasetZarr(tmp_path / "store").get_position_ids()
    pipeline = builders.build_pipeline_steps(
        channels_to_segment={"nuclei": 0, "cell": 3}, channels_to_extract=[0, 3],
        features_to_extract=("intensity", "sizeshape"),
        cp_measure_feature_kwargs={"intensity": {"edge_measurements": False}})
    for obj in ("nuclei", "cell"):
        pipeline["steps"][f"track_{obj}"] = {"kind": "stitch", "max_labels": 256,
                                             "iou_threshold": 0.25}
        pipeline["passed_data"][f"track_{obj}"] = [("masks", f"segment_{obj}")]
    pipeline.update(ntps=4, compiled=True)
    want, _ = pipeline_mesh.run_positions_mesh_states(
        pipeline, positions, tmp_path / "dp1", capture_order="TCZYX", device=dev, chunk=2)
    real = pipeline_mesh.try_compile_sharded
    pipeline_mesh.try_compile_sharded = lagging
    try:
        got, _ = pipeline_mesh.run_positions_mesh_states(
            pipeline, positions, tmp_path / "dp2", capture_order="TCZYX", chunk=2,
            mesh=make_mesh(devices=["cuda:0"] * 2))
    finally:
        pipeline_mesh.try_compile_sharded = real
    for g, w in zip(got, want):
        gc, wc = (profile_columns(e["state"], e["pipeline"]) for e in (g, w))
        assert list(gc) == list(wc)
        for k in wc:
            assert np.array_equal(np.asarray(gc[k]), np.asarray(wc[k]),
                                  equal_nan=np.asarray(wc[k]).dtype.kind == "f"), k
        for step in ("segment_nuclei", "segment_cell"):
            a, b = g["state"]["data"][step], w["state"]["data"][step]
            assert len(a) == len(b) == 4
            assert all(np.array_equal(x, y) for ta, tb in zip(a, b) for x, y in zip(ta, tb))
        for step in ("track_nuclei", "track_cell"):
            a, b = g["state"]["data"][step], w["state"]["data"][step]
            assert len(a) == len(b) and all(
                x["max_label"] == y["max_label"]
                and all(np.array_equal(u, v) for u, v in zip(x["labels"], y["labels"]))
                for x, y in zip(a, b)), step
