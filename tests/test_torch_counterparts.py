"""The last functions of the JAX package that had no counterpart in the port,
each against its JAX function on seeded numpy inputs, and the comparison
of the two packages' public top-level names.

Tolerances: exact (equal bits) for ``downscale_mean`` (the port sums each
block in XLA's order and multiplies by the f32 reciprocal, as XLA's mean
does), ``connected_components_hybrid`` (the same ids), the integer shifts of
``phase_cross_correlation`` (a unique peak: pocketfft and cuFFT round the
spectrum differently, so ties are not held), ``convex_area_from_extents``,
``REDUCTION_FUNS``, ``render_dense_cells`` and the yeast fixtures (pixels
and zarr chunk bytes). The parabolic refinement of
``phase_cross_correlation(upsample_factor=4)`` reads the correlation's
magnitude beside the peak, where the two FFTs differ in the last bits: the
shift is held within ``SUBPIXEL_ATOL`` pixels.
"""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from scipy import ndimage as ndi

from aliby_tpu import test_data as jax_data
from aliby_tpu.extract import extract as jax_extract
from aliby_tpu.extract import reductions as jax_reductions
from aliby_tpu.ops import imageops as jax_imageops
from aliby_tpu.ops import labels as jax_labels
from aliby_tpu_torch import test_data
from aliby_tpu_torch.extract import extract, reductions
from aliby_tpu_torch.io import zarrlite
from aliby_tpu_torch.ops import imageops, labels

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SUBPIXEL_ATOL = 1e-3


def _shift_pair(rng, size=(96, 80)):
    base = ndi.gaussian_filter(rng.normal(size=size), 2).astype(np.float32)
    shift = tuple(int(s) for s in rng.integers(-20, 21, 2))
    return base, np.roll(base, shift, (0, 1)), shift


def test_phase_cross_correlation_reference_case():
    """``tests/test_ops_imageops.py``'s case: (5, -7)."""
    rng = np.random.default_rng(0)
    base = ndi.gaussian_filter(rng.normal(size=(128, 128)), 3)
    shifted = np.roll(np.roll(base, 5, axis=0), -7, axis=1)
    got = imageops.phase_cross_correlation(torch.from_numpy(shifted), torch.from_numpy(base))
    want = np.asarray(jax_imageops.phase_cross_correlation(shifted, base))
    assert got.dtype == torch.float32 and got.tolist() == want.tolist() == [5.0, -7.0]


def test_phase_cross_correlation_integer_shifts():
    rng = np.random.default_rng(1)
    pairs = [_shift_pair(rng) for _ in range(6)]
    refs = torch.from_numpy(np.stack([m for _, m, _ in pairs]))
    movs = torch.from_numpy(np.stack([b for b, _, _ in pairs]))
    batched = imageops.phase_cross_correlation(refs, movs)
    for i, (base, moved, shift) in enumerate(pairs):
        want = np.asarray(jax_imageops.phase_cross_correlation(moved, base))
        got = imageops.phase_cross_correlation(torch.from_numpy(moved), torch.from_numpy(base))
        assert got.tolist() == want.tolist() == list(map(float, shift))
        assert batched[i].tolist() == want.tolist()


def test_phase_cross_correlation_upsampled():
    rng = np.random.default_rng(2)
    for k in range(4):
        base, moved, shift = _shift_pair(rng)
        if k % 2:  # a sub-pixel shift (the spectrum's phase ramp)
            fy, fx = np.meshgrid(np.fft.fftfreq(96), np.fft.fftfreq(80), indexing="ij")
            d = np.array(shift) + rng.uniform(-0.5, 0.5, 2)
            moved = np.real(np.fft.ifft2(np.fft.fft2(base) * np.exp(
                -2j * np.pi * (fy * d[0] + fx * d[1])))).astype(np.float32)
        want = np.asarray(jax_imageops.phase_cross_correlation(moved, base, upsample_factor=4))
        got = imageops.phase_cross_correlation(torch.from_numpy(moved), torch.from_numpy(base),
                                               upsample_factor=4)
        np.testing.assert_array_equal(np.round(got.numpy()), np.round(want))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SUBPIXEL_ATOL)


@pytest.mark.parametrize("factor, shape", [(2, (37, 41)), (3, (50, 29)), (3, (64, 64)),
                                           (2, (1, 7))])
def test_downscale_mean(factor, shape):
    rng = np.random.default_rng(factor * 100 + shape[0])
    for img in (rng.random(shape, dtype=np.float32) * 1000,
                rng.integers(0, 2**16, shape, dtype=np.uint16)):
        want = np.asarray(jax_imageops.downscale_mean(jnp.asarray(img), factor))
        got = imageops.downscale_mean(torch.from_numpy(img.astype(np.int32) if img.dtype ==
                                                       np.uint16 else img), factor)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
    batch = rng.random((3, *shape), dtype=np.float32)
    got = imageops.downscale_mean(torch.from_numpy(batch), factor)
    for i in range(3):
        np.testing.assert_array_equal(
            got[i].numpy(), np.asarray(jax_imageops.downscale_mean(jnp.asarray(batch[i]), factor)))


def _cc_masks() -> list[np.ndarray]:
    """``tests/test_ops_labels.py``'s two masks, and a serpentine component
    longer than phase 1's reach."""
    rng = np.random.default_rng(3)
    blobs = np.zeros((128, 128), bool)
    yy, xx = np.ogrid[:128, :128]
    for _ in range(40):
        cy, cx = rng.integers(6, 122, 2)
        blobs |= (yy - cy) ** 2 + (xx - cx) ** 2 <= rng.integers(1, 5) ** 2
    large = np.zeros((128, 128), bool)
    large[20:80, 20:80] = True
    large[100, 5:120] = True
    large[5:60, 110] = True
    snake = np.zeros((128, 128), bool)
    for i, r in enumerate(range(2, 126, 4)):
        snake[r, 2:126] = True
        snake[r:r + 4, 125 if i % 2 == 0 else 2] = True
    snake[60:70, 60:70] = True  # and a block that touches it
    snake[40, 40] = False
    return [blobs, large, snake]


@pytest.mark.parametrize("connectivity", [1, 2])
def test_connected_components_hybrid(connectivity):
    masks = _cc_masks()
    got = labels.connected_components_hybrid(torch.from_numpy(np.stack(masks)), connectivity)
    for mask, g in zip(masks, got):
        want = np.asarray(jax_labels.connected_components_hybrid(jnp.asarray(mask),
                                                                  connectivity))
        np.testing.assert_array_equal(g.numpy(), want)
        # the ids: each component's smallest flat pixel index + 1
        comp, n = ndi.label(mask, np.ones((3, 3)) if connectivity == 2 else None)
        for c in range(1, n + 1):
            ids = np.unique(want[comp == c])
            assert ids.tolist() == [np.flatnonzero(comp == c)[0] + 1]
    alone = labels.connected_components_hybrid(torch.from_numpy(masks[2][None]), connectivity)
    np.testing.assert_array_equal(alone[0].numpy(), got[2].numpy())


def test_connected_components_hybrid_backstop():
    """``max_hook`` bounds phase 2 as the reference's ``while_loop`` does."""
    mask = _cc_masks()[2]
    for n_local, max_hook in ((0, 1), (2, 2), (1, 3)):
        want = np.asarray(jax_labels.connected_components_hybrid(
            jnp.asarray(mask), 2, n_local, max_hook))
        got = labels.connected_components_hybrid(torch.from_numpy(mask[None]), 2, n_local,
                                                 max_hook)
        np.testing.assert_array_equal(got[0].numpy(), want)


def test_convex_area_from_extents_and_reduction_funs():
    rng = np.random.default_rng(4)
    lab = np.stack([jax_data.render_cells(96, 8, rng)[2] for _ in range(2)])
    for n_dir in (64, 180):
        got = reductions.convex_area_from_extents(torch.from_numpy(lab), 16, n_dir=n_dir)
        want = np.stack([np.asarray(jax_reductions.convex_area_from_extents(
            jnp.asarray(x), 16, n_dir=n_dir)) for x in lab])
        np.testing.assert_array_equal(got.numpy(), want)
    assert extract.REDUCTION_FUNS == jax_extract.REDUCTION_FUNS


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_render_dense_cells(seed):
    kw = dict(rmin=4.0, rmax=10.0) if seed == 2 else {}
    got = test_data.render_dense_cells(96, 40, np.random.default_rng(seed), **kw)
    want = jax_data.render_dense_cells(96, 40, np.random.default_rng(seed), **kw)
    assert got.dtype == want.dtype == np.int32 and got.max() > 20
    np.testing.assert_array_equal(got, want)


def _planes(path: Path) -> list[np.ndarray]:
    with Image.open(path) as im:
        out = []
        for i in range(getattr(im, "n_frames", 1)):
            im.seek(i)
            out.append(np.asarray(im))
    return out


@pytest.mark.parametrize("name", ["yeast_tiff", "yeast_multitiff", "yeast_zarr"])
def test_yeast_fixtures_are_the_jax_packages(name):
    assert test_data.get_dataset(name) == jax_data.get_dataset(name)
    ours, theirs = test_data.get_dataset_path(name), jax_data.get_dataset_path(name)
    files = sorted(p.relative_to(theirs) for p in theirs.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(ours) for p in ours.rglob("*") if p.is_file())
    for f in files:
        if f.suffix == ".tif":
            a, b = _planes(ours / f), _planes(theirs / f)
            assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b)), f
        else:  # zarr metadata and chunks
            assert (ours / f).read_bytes() == (theirs / f).read_bytes(), f
    if name == "yeast_zarr":
        assert zarrlite.ZarrArray(ours / "pos1").shape == (4, 3, 3, 293, 293)


def test_get_data_root(tmp_path, monkeypatch):
    calls = []
    monkeypatch.setattr(test_data, "get_dataset_path", lambda name: calls.append(name))
    monkeypatch.setenv("ALIBY_TPU_TORCH_FIXTURES", str(tmp_path))
    assert test_data.get_data_root() == tmp_path
    assert calls == list(jax_data.DATASETS) == list(test_data.DATASETS)


# ---------------------------------------------------------------------------
# every public top-level name of aliby_tpu has a counterpart
# ---------------------------------------------------------------------------

# modules of the port under other names
MODULES = {"ops/pallas_segsum.py": "ops/segsum.py", "ops/pallas_stencil.py": "ops/stencil.py"}
# names of the port under other names
RENAMED = {("models/segment.py", "CellposeTPU"): "CellposeTorch",
           ("utils/profiling.py", "annotate"): "span"}
# names with no counterpart, and why
NOT_PORTED = {
    **{f"models/cpnet.py:{n}": "Flax modules of CPnetFlax: the port's CPnet is torch and loads "
       "the published state_dict itself" for n in (
           "BatchConv", "BatchConvStyle", "CPnetFlax", "ResDown", "ResUp", "TorchBatchNorm",
           "convert_torch_state_dict")},
    "ops/pallas_segsum.py:benchmark": "the TPU kernel's timing loop: chip_smoke.py phase 4 "
                                      "times the CUDA kernels",
}


def _public_names(path: Path, imported: bool) -> set:
    """The module's public top-level names: what it defines, and with
    ``imported`` also what it imports by name."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif imported and isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


def test_every_public_name_has_a_counterpart():
    missing = []
    for ref in sorted((ROOT / "aliby_tpu").rglob("*.py")):
        rel = str(ref.relative_to(ROOT / "aliby_tpu"))
        if rel in NOT_PORTED:
            continue
        port = ROOT / "aliby_tpu_torch" / MODULES.get(rel, rel)
        have = _public_names(port, True) if port.exists() else set()
        for name in sorted(_public_names(ref, False)):
            if f"{rel}:{name}" in NOT_PORTED:
                continue
            if RENAMED.get((rel, name), name) not in have:
                missing.append(f"{rel}:{name}")
    assert not missing, missing
