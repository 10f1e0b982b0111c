"""The port's BABY path against the JAX package's, on the CPU.

- ``models.baby``: ``make_baby_segmenter`` on ``render_budding_movie``
  with perfect masks (ids shuffled each frame, so the tracker works): the
  layered masks and the ``cell_label``/``mother_assign`` metadata equal
  JAX's every frame, and the lineage is exact (every bud to its mother).
- ``engine.baby_parser``: the tracking table equals JAX's, as numpy
  columns and as a pyarrow table.
- ``pipe_baby.run_pipeline_and_post(device="cpu")`` with
  ``build_pipeline_steps(base_kind="threshold")`` on a 160 x 160 yeast
  time-lapse (3 tps, drift tracking on) against ``aliby_tpu.pipe_baby``:
  profile names, rows and metadata exact, features within
  ``aliby_tpu_torch.extract.tolerances``; the tracking parquet equal; the
  saved ``.npz`` layered masks bit-equal; the tracking table of the state
  path (``tracking_columns``) equal to the parquet's; ``run_positions``
  with ``flavor="baby"`` giving the same tables.
"""

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

from aliby_tpu.engine.baby_parser import baby_tracking_to_table as jax_tracking_table
from aliby_tpu.models.baby import make_baby_segmenter as jax_make_baby
from aliby_tpu.pipe_baby import run_pipeline_and_post as jax_run_baby
from aliby_tpu.pipe_builder_baby import build_pipeline_steps as jax_build_baby
from aliby_tpu_torch.engine import core
from aliby_tpu_torch.engine.baby_parser import baby_tracking_columns, baby_tracking_to_table
from aliby_tpu_torch.io import zarrlite
from aliby_tpu_torch.models.baby import _layered, make_baby_segmenter
from aliby_tpu_torch.pipe_baby import init_step, run_pipeline_and_post, tracking_columns
from aliby_tpu_torch.pipe_builder_baby import build_pipeline_steps
from aliby_tpu_torch.test_data import render_budding_movie, yeast_timelapse
from test_torch_runner import assert_profiles_match

torch.set_num_threads(1)
T = 8


def _perfect_base(gt_labels, seed):
    counter = {"t": 0}

    def base(pixels, **_):
        t = counter["t"]
        counter["t"] += 1
        m = gt_labels[t]
        ids = np.unique(m)[1:]
        perm = np.zeros(m.max() + 1, np.int32)
        perm[ids] = np.random.default_rng(t + seed).permutation(len(ids)) + 1
        return [perm[m]]

    return base


@pytest.mark.parametrize("seed", [5, 11, 23])
def test_lineage_exact_with_perfect_masks(seed):
    rng = np.random.default_rng(seed)
    frames, gt_labels, gt_lineage = render_budding_movie(160, T, rng, n_mothers=5,
                                                         bud_max_radius=7.0)
    seg = make_baby_segmenter(base_fn=_perfect_base(gt_labels, seed), device="cpu")
    jseg = jax_make_baby(base_fn=_perfect_base(gt_labels, seed))
    detected, metas = {}, []
    for t in range(T):
        out, want = seg(frames[t][None, None, None]), jseg(frames[t][None, None, None])
        assert out["metadata"] == want["metadata"]
        np.testing.assert_array_equal(out["masks"][0], want["masks"][0])
        metas.append(out["metadata"])
        track = out["masks"][0].max(axis=0)
        labels, ma = out["metadata"]["cell_label"][0], out["metadata"]["mother_assign"][0]
        for j, lbl in enumerate(labels):
            if ma[j] and lbl not in detected:
                # map the daughter and mother tracks to ground truth by overlap
                def gt_of(track_id):
                    return int(np.bincount(gt_labels[t][track == track_id]).argmax())
                detected[gt_of(lbl)] = gt_of(labels[ma[j] - 1])
    assert detected == {b: m for b, m in gt_lineage.items() if b in detected}
    assert len(detected) >= len(gt_lineage) - 1  # a bud born on the last tp may be unseen
    cols = baby_tracking_columns(metas)
    want = jax_tracking_table(metas)
    assert baby_tracking_to_table(metas).equals(want)
    assert {k: v.tolist() for k, v in cols.items()} == want.to_pydict()


def test_layered():
    m = np.array([[0, 1, 2], [3, 4, 0]], np.uint16)
    got = _layered(m, 3)
    assert got.shape == (3, 2, 3)
    np.testing.assert_array_equal(got.max(axis=0), m)
    assert got[1, 0, 1] == 1 and got[2, 0, 2] == 2 and got[0, 1, 0] == 3 and got[1, 1, 1] == 4


def test_builder_and_flavour():
    p = build_pipeline_steps(channels_to_segment={"cell": 0}, base_kind="threshold")
    assert p == jax_build_baby(channels_to_segment={"cell": 0}, base_kind="threshold")
    assert p["passed_methods"]["segment_cell"] == ("tile", "get_fczyx")
    with pytest.raises(ValueError, match="extractmulti"):
        init_step("extractmulti_cell", {})


def _pipeline(build, root, ntps=3):
    p = build(channels_to_segment={"cell": 1}, channels_to_extract=[1, 2],
              features_to_extract=("intensity", "sizeshape"), tile_size=None,
              base_kind="threshold", threshold_scale=0.6)
    p["steps"]["tile"]["image_kwargs"] = {"source": {"key": "pos1", "path": str(root / "pos1")},
                                          "capture_order": "TCZYX"}
    p["steps"]["tile"]["track_drift"] = True
    p["ntps"] = ntps
    return p


@pytest.fixture(scope="module")
def baby_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("baby")
    zarrlite.write_array(root / "pos1", yeast_timelapse(41, T=3, size=160),
                         chunks=(1, 1, 1, 160, 160))
    want, _ = jax_run_baby(pipeline=_pipeline(jax_build_baby, root), pipeline_name="pos1",
                           output_path=root / "jax", overwrite=True)
    got, _ = run_pipeline_and_post(pipeline=_pipeline(build_pipeline_steps, root),
                                   pipeline_name="pos1", output_path=root / "port",
                                   overwrite=True, device="cpu")
    return root, got, want


def test_baby_profiles_match(baby_runs):
    _, got, want = baby_runs
    assert got.num_rows > 10
    assert_profiles_match(got, want)
    assert set(got.column("metadata_tp").to_pylist()) == {0, 1, 2}


def test_baby_tracking_parquet_and_saves(baby_runs):
    root, _, _ = baby_runs
    f = "tracking/pos1_segment_cell.parquet"
    got, want = pq.read_table(root / "port" / f), pq.read_table(root / "jax" / f)
    assert got.equals(want)
    assert set(got.column_names) == {"tile", "timepoint", "cell_label", "mother_label"}
    seg = "steps/pos1/segment_cell"
    files = sorted((root / "port" / seg).glob("*.npz"))
    assert files and [p.name for p in files] == [p.name for p in
                                                 sorted((root / "jax" / seg).glob("*.npz"))]
    for p in files:
        with np.load(p) as a, np.load(root / "jax" / seg / p.name) as b:
            assert list(a.keys()) == list(b.keys()) and "tile_0" in a
            assert a["tile_0"].ndim == 3
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    assert (root / "port" / seg / "0000_meta.json").exists()


def test_baby_state_path_needs_no_parquet(baby_runs):
    root, got, _ = baby_runs
    pipe = _pipeline(build_pipeline_steps, root)
    pipe["retain"] = {"segment_cell": 1}  # the metadata survives retain-trimming
    state = core.run_pipeline_return_state(pipe, root / "state", init_step, device="cpu")
    cols = tracking_columns(state, pipe)["segment_cell"]
    want = pq.read_table(root / "port" / "tracking/pos1_segment_cell.parquet").to_pydict()
    assert {k: v.tolist() for k, v in cols.items()} == want
    prof = core.profile_columns(state, pipe)
    assert prof["metadata_label"].tolist() == got.column("metadata_label").to_pylist()


def test_run_positions_baby_flavour(baby_runs, tmp_path):
    """``run_positions(flavor="baby")`` runs the BABY flavour: the same
    profiles and tracking parquet as ``pipe_baby.run_pipeline_and_post``."""
    from aliby_tpu_torch.parallel.positions import run_positions

    root, got, _ = baby_runs
    base = _pipeline(build_pipeline_steps, root)
    position = {"key": "pos1", "path": str(root / "pos1")}
    out = run_positions(base, [position], tmp_path, capture_order="TCZYX", n_workers=1,
                        flavor="baby", devices=["cpu"])
    assert out["pos1"][0].equals(got)
    assert pq.read_table(tmp_path / "tracking/pos1_segment_cell.parquet").equals(
        pq.read_table(root / "port" / "tracking/pos1_segment_cell.parquet"))
