"""The port's production runner against the JAX package's, on the CPU.

A two-position, four-timepoint, five-channel 96x96 zarr movie
(``aliby_tpu_torch.test_data.cellpainting_movie``) goes through the
``build_pipeline_steps`` pipeline (nuclei + cell, intensity and the coloc tree on two
channels, the U-Net in f32) with a stitch tracker per object, compiled:

- ``run_pipeline_and_post`` per timepoint against the JAX package's run of
  the same pipeline: the profiles parquet column by column (the metadata
  and integer-valued columns exact, float features within
  ``aliby_tpu_torch.extract.tolerances``, costes at most 5% of its values),
  and every saved segment and tracker ``.npz`` bit-equal;
- the movie path (``movie_chunk`` 3 over 4 timepoints: a tracker carry
  across chunks and a ragged one-timepoint tail) and ``run_positions_mesh``
  (``chunk`` 3, both positions in each call) bit-identical to the per-tp
  path: profiles (NaN equal to NaN), tracker states and saves, also when
  the mesh's calls hold fewer fields than the plate and its positions run
  in groups (``plan_calls``).

``tests/test_torch_runner_interpreted.py`` holds the interpreted path, the
3-D segmenter and the global linker.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

from aliby_tpu.engine.builders import build_pipeline_steps as jax_build_pipeline_steps
from aliby_tpu.parallel.positions import stamp_image_kwargs as jax_stamp
from aliby_tpu.pipe import run_pipeline_and_post as jax_run_pipeline_and_post
from aliby_tpu_torch.engine.builders import build_pipeline_steps
from aliby_tpu_torch.engine.compiled import FIELD_BYTES_PER_PIXEL, CompiledStep
from aliby_tpu_torch.extract.tolerances import (
    INTEGER_VALUED,
    THRESHOLD_DECIDED,
    THRESHOLD_SHARE,
    beyond_tolerance,
)
from aliby_tpu_torch.io import zarrlite
from aliby_tpu_torch.io.dataset import DatasetZarr
from aliby_tpu_torch.parallel import pipeline_mesh
from aliby_tpu_torch.parallel.pipeline_mesh import plan_calls, run_positions_mesh
from aliby_tpu_torch.parallel.positions import stamp_image_kwargs
from aliby_tpu_torch.pipe import run_pipeline_and_post
from aliby_tpu_torch.test_data import cellpainting_movie

torch.set_num_threads(1)

NTPS = 4
SIZE = 96
OBJECTS = ("nuclei", "cell")
SAVED = [f"segment_{o}" for o in OBJECTS] + [f"track_{o}" for o in OBJECTS]


def runner_pipeline(build, dtype, ntps: int = NTPS, **extra) -> dict:
    """``build_pipeline_steps``' pipeline with a stitch tracker per object; the U-Net
    in ``dtype`` (f32 on both sides where labels are held bit-equal to the
    JAX package's: bf16 rounds at other places in the two frameworks)."""
    pipeline = build(channels_to_segment={"nuclei": 0, "cell": 3}, channels_to_extract=[0, 3],
                     features_to_extract=("intensity",),
                     segmenter_extra_kwargs={"model_kwargs": {"dtype": dtype}})
    for obj in OBJECTS:
        pipeline["steps"][f"track_{obj}"] = {"kind": "stitch", "max_labels": 256,
                                             "iou_threshold": 0.25}
        pipeline["passed_data"][f"track_{obj}"] = [("masks", f"segment_{obj}")]
    pipeline["save"] = list(SAVED)
    pipeline.update(ntps=ntps, **extra)
    return pipeline


def port_pipeline(**extra) -> dict:
    return runner_pipeline(build_pipeline_steps, torch.float32, compiled=True, **extra)


def write_movie(root: Path, n_pos: int = 2) -> list[dict]:
    movie = cellpainting_movie(n_pos, NTPS, SIZE, seed=3, n_cells=8)
    for p in range(n_pos):
        zarrlite.write_array(root / f"pos{p}", movie[p], chunks=(1, 1, 1, SIZE, SIZE))
    return DatasetZarr(root).get_position_ids()


def assert_profiles_match(got, want) -> None:
    """Port vs JAX profile tables: names and metadata equal, integer-valued
    columns exact, float features within the parity tolerances."""
    assert got.column_names == want.column_names
    assert got.num_rows == want.num_rows > 0
    cols = {n: np.asarray(got.column(n).to_pylist()) for n in got.column_names}
    ref = {n: np.asarray(want.column(n).to_pylist()) for n in want.column_names}
    for name in got.column_names:
        if name.startswith("metadata_"):
            assert cols[name].tolist() == ref[name].tolist(), name
            continue
        branch, feat = name.rsplit("/", 1)
        bad = beyond_tolerance(
            feat, cols[name].astype(float), ref[name].astype(float),
            lambda other: ref.get(f"{branch}/{other}", ref[name]).astype(float))
        if feat in INTEGER_VALUED:
            np.testing.assert_array_equal(cols[name], ref[name], err_msg=name)
        elif feat in THRESHOLD_DECIDED:
            assert bad.sum() <= max(1, int(THRESHOLD_SHARE * len(bad))), name
        else:
            assert not bad.any(), (name, cols[name][bad], ref[name][bad])


def assert_same_bits(a, b) -> None:
    """Two of the port's profile tables: identical, NaN equal to NaN."""
    assert a.column_names == b.column_names and a.num_rows == b.num_rows
    for name in a.column_names:
        x, y = a.column(name), b.column(name)
        assert x.type == y.type, name
        x, y = np.asarray(x.to_pylist()), np.asarray(y.to_pylist())
        if x.dtype.kind == "f":
            assert np.array_equal(x, y, equal_nan=True), name
        else:
            assert x.tolist() == y.tolist(), name


def assert_same_saves(a: Path, b: Path) -> None:
    files = sorted(p.relative_to(a) for p in a.rglob("*.npz"))
    assert files and files == sorted(p.relative_to(b) for p in b.rglob("*.npz"))
    assert {f.parts[0] for f in files} == set(SAVED)
    for f in files:
        with np.load(a / f) as x, np.load(b / f) as y:
            assert sorted(x.keys()) == sorted(y.keys())
            for k in x.keys():
                assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), (f, k)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("runner")
    positions = write_movie(root / "store")
    out = {"positions": positions, "root": root}
    jax_pipe = jax_stamp(runner_pipeline(jax_build_pipeline_steps, jnp.float32, compiled=True,
                                         movie=False), positions[0], capture_order="TCZYX")
    out["jax"] = jax_run_pipeline_and_post(jax_pipe, "pos0", root / "jax")[0]
    for name, extra in (("per_tp", dict(movie=False)), ("movie", dict(movie_chunk=3))):
        pipe = stamp_image_kwargs(port_pipeline(**extra), positions[0], capture_order="TCZYX")
        out[name] = run_pipeline_and_post(pipe, "pos0", root / name, device="cpu")[0]
    mesh = run_positions_mesh(port_pipeline(), positions, root / "mesh", capture_order="TCZYX",
                              device="cpu", chunk=3)
    out["mesh"], out["mesh_pos1"] = mesh["pos0"][0], mesh["pos1"][0]
    return out


def test_per_tp_profiles_match_jax(runs):
    assert_profiles_match(runs["per_tp"], runs["jax"])
    written = pq.read_table(runs["root"] / "per_tp" / "profiles" / "pos0.parquet")
    assert written.equals(runs["per_tp"])
    assert set(runs["per_tp"].column("metadata_tp").to_pylist()) == set(range(NTPS))


def test_per_tp_saves_match_jax(runs):
    assert_same_saves(runs["root"] / "per_tp" / "steps" / "pos0",
                      runs["root"] / "jax" / "steps" / "pos0")
    with np.load(runs["root"] / "per_tp" / "steps" / "pos0" / "track_cell" / "0003.npz") as z:
        assert z["max_label"][0] >= z["labels"][0].max() > 0


@pytest.mark.parametrize("path", ["movie", "mesh"])
def test_movie_and_mesh_are_the_per_tp_bits(runs, path):
    assert_same_bits(runs[path], runs["per_tp"])
    assert_same_saves(runs["root"] / path / "steps" / "pos0",
                      runs["root"] / "per_tp" / "steps" / "pos0")


def test_mesh_second_position_is_its_per_tp_run(runs, tmp_path):
    pipe = stamp_image_kwargs(port_pipeline(movie=False), runs["positions"][1],
                              capture_order="TCZYX")
    alone = run_pipeline_and_post(pipe, "pos1", tmp_path, device="cpu")[0]
    assert_same_bits(runs["mesh_pos1"], alone)
    assert_same_saves(runs["root"] / "mesh" / "steps" / "pos1", tmp_path / "steps" / "pos1")
    # a finished position is skipped unless overwrite
    assert run_pipeline_and_post(pipe, "pos1", tmp_path, device="cpu") == (None, None)


def test_mesh_in_groups_is_the_mesh_bits(runs, tmp_path, monkeypatch):
    """Calls of at most 3 fields: chunks of 3 tps, one position a call."""
    plans = []

    def spy(*args):
        plans.append(plan_calls(*args))
        return plans[-1]

    monkeypatch.setattr(CompiledStep, "max_fields", lambda self, field_pixels: 3)
    monkeypatch.setattr(pipeline_mesh, "plan_calls", spy)
    mesh = run_positions_mesh(port_pipeline(), runs["positions"], tmp_path, capture_order="TCZYX",
                              device="cpu", chunk=3)
    assert plans == [(1, 3)]
    assert_same_bits(mesh["pos0"][0], runs["mesh"])
    assert_same_bits(mesh["pos1"][0], runs["mesh_pos1"])
    for key in ("pos0", "pos1"):
        assert_same_saves(tmp_path / "steps" / key, runs["root"] / "mesh" / "steps" / key)


# an H100's 80 GB free: 1080^2 fields of two objects a call
FIT_1080 = int(0.9 * 80e9) // (FIELD_BYTES_PER_PIXEL * 1080 * 1080 * 2)


@pytest.mark.parametrize("args, want", [
    # a plate of 24 positions at 1080^2 does not fit one call: 3 groups
    ((24, 1, 7, None, FIT_1080, True), (8, 1)),
    ((24, 1, 7, 3, FIT_1080, True), (3, 3)),
    # a chunk too long for one position is shortened
    ((2, 1, 20, 16, FIT_1080, True), (1, FIT_1080)),
    # two positions of 4 tiles, 7 tps: chunks of 4 + 3, one call
    ((2, 4, 7, None, FIT_1080 * 4, True), (2, 4)),
    # off the card: no limit, the reference's ~32-tile chunk sizing
    ((24, 1, 7, None, None, True), (24, 1)),
    ((2, 1, 7, None, None, True), (2, 4)),
    # no whole-movie tracker: one tp a call
    ((2, 1, 7, 3, None, False), (2, 1)),
])
def test_plan_calls(args, want):
    assert FIT_1080 == 10
    assert plan_calls(*args) == want
