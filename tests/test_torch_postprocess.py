"""Port parity: ``aliby_tpu_torch.postprocess`` (Cells, Signal, indexing,
progress) against ``aliby_tpu.postprocess`` on one run directory, written
once by the JAX package's yeast pipeline as ``tests/test_postprocess.py``
writes it. Every query must give equal results (arrays bit-equal, frames
equal with NaN positions equal)."""

import numpy as np
import pandas as pd
import pytest

from aliby_tpu import postprocess as J
from aliby_tpu.io.dataset import DatasetZarr
from aliby_tpu.pipe_baby import run_pipeline_and_post
from aliby_tpu.pipe_builder_baby import build_pipeline_steps
from aliby_tpu.postprocess import indexing as JI
from aliby_tpu.postprocess import progress as JP
from aliby_tpu.test_data import get_dataset_path
from aliby_tpu_torch import postprocess as P
from aliby_tpu_torch.postprocess import indexing as PI
from aliby_tpu_torch.postprocess import progress as PP


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory, data_dir):
    root = get_dataset_path("yeast_zarr")
    position = DatasetZarr(root).get_position_ids()[0]
    pipeline = build_pipeline_steps(
        channels_to_segment={"cell": 1},
        channels_to_extract=[1],
        features_to_extract=("intensity",),
        tile_size=None,
        base_kind="threshold",
        threshold_scale=0.6,
    )
    pipeline["steps"]["tile"]["image_kwargs"] = {
        "source": {"key": position["key"], "path": position["path"]},
        "capture_order": "TCZYX",
    }
    pipeline["ntps"] = 3
    out = tmp_path_factory.mktemp("post")
    run_pipeline_and_post(pipeline=pipeline, pipeline_name=position["key"],
                          output_path=out, overwrite=True)
    return out, position["key"]


def _equal(got, want):
    if isinstance(want, pd.DataFrame):
        pd.testing.assert_frame_equal(got, want)
    elif isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


CELLS_QUERIES = {
    "ntimepoints": lambda c: c.ntimepoints,
    "masks_at_time": lambda c: [c.masks_at_time(t) for t in range(3)],
    "labels_at_time": lambda c: [c.labels_at_time(t) for t in range(3)],
    "labels": lambda c: c.labels,
    "presence_matrix": lambda c: c.presence_matrix(0),
    "outlines_at_time": lambda c: [c.outlines_at_time(t) for t in range(3)],
    "at_time": lambda c: [c.at_time(0), c.at_time(2, kind="edgemask")],
    "at_times": lambda c: c.at_times(range(3)),
    "where_mask_outline": lambda c: [q(lbl, 0) for lbl in c.labels[0][:4]
                                     for q in (c.where, c.mask, c.outline)],
    "inventories": lambda c: [c.cell_labels_in_trap(0), c.nonempty_tp_in_trap(0), c.ntraps,
                              c.max_labels, c.max_label, c.cell_labels_in_trap(5)],
    "presence_tensors": lambda c: [c.cells_vs_tps, c.tiles_vs_cells_vs_tps],
    "retention": lambda c: [c.cell_tp_where(3), c.cell_tp_where(1, interval=(1, 2)),
                            c.retained(3), c.retained(2)],
    "lineage": lambda c: [c.mothers_daughters(), c.mothers_daughters_matrix(0),
                          c.mothers_in_trap(0)],
}


@pytest.mark.parametrize("query", list(CELLS_QUERIES))
def test_cells_queries_match_jax(run_dir, query):
    out, pos = run_dir
    fn = CELLS_QUERIES[query]
    want = fn(J.Cells(out, pos, step="segment_cell"))
    got = fn(P.Cells(out, pos, step="segment_cell"))
    _equal(got, want)


def test_signal_matches_jax(run_dir):
    out, pos = run_dir
    want_sig, got_sig = J.Signal(out, pos), P.Signal(out, pos)
    assert got_sig.columns == want_sig.columns
    col = next(c for c in want_sig.columns if c.endswith("Intensity_MeanIntensity"))
    want, got = want_sig[col], got_sig[col]
    _equal(got, want)
    assert list(got.columns) == [0, 1, 2] and got.shape[0] > 5
    _equal(got_sig.retained(got, fraction=1.0), want_sig.retained(want, fraction=1.0))
    _equal(got_sig.get(col, metadata_object="cell"), want_sig.get(col, metadata_object="cell"))
    _equal(got_sig.lineage(), want_sig.lineage())
    _equal(got_sig.tracking(), want_sig.tracking())
    _equal(got_sig.get_with_lineage(col), want_sig.get_with_lineage(col))
    rows = np.asarray([list(ix) for ix in want.index[:3]])
    merges = np.stack([rows[[1, 2]], rows[[0, 1]]], axis=1)  # row 1 -> 2, row 0 -> 1
    _equal(got_sig.merge_tracks(got, merges), want_sig.merge_tracks(want, merges))


def test_progress_matches_jax(run_dir):
    out, pos = run_dir
    step_dir = out / "steps" / pos / "segment_cell"
    _equal(PP.count_objects_per_tp(step_dir), JP.count_objects_per_tp(step_dir))
    for nspecial in (1, 2, 3):
        assert PP.get_npairs(step_dir, nspecial) == JP.get_npairs(step_dir, nspecial)
    positions = [pos, "ghost_position"]
    _equal(PP.run_progress(out, positions), JP.run_progress(out, positions))


def test_indexing_matches_jax():
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 4, (40, 2))
    targets = rng.integers(0, 4, (12, 2))
    _equal(PI.index_isin(idx, targets), JI.index_isin(idx, targets))
    _equal(PI.index_isin(idx, targets[:0]), JI.index_isin(idx, targets[:0]))
    merges = np.array([[[0, 1], [0, 2]], [[0, 2], [0, 3]], [[1, 5], [1, 6]], [[0, 7], [0, 1]]])
    _equal(PI.group_merges(merges), JI.group_merges(merges))
    _equal(PI.group_merges(merges[:, :, 1]), JI.group_merges(merges[:, :, 1]))
    index = np.array([[0, 1], [0, 2], [0, 3], [1, 5], [1, 6]])
    values = rng.normal(size=(5, 6))
    values[rng.random((5, 6)) < 0.4] = np.nan
    _equal(PI.apply_merges(values, index, merges), JI.apply_merges(values, index, merges))
    _equal(PI.join_two_tracks(values, 0, 3), JI.join_two_tracks(values, 0, 3))
    lineage = np.array([[[0, 1], [0, 2]], [[0, 9], [0, 2]], [[1, 5], [1, 6]], [[0, 3], [0, 8]]])
    _equal(PI.validate_lineage(lineage, index), JI.validate_lineage(lineage, index))
    _equal(PI.validate_lineage(lineage[3:], index), JI.validate_lineage(lineage[3:], index))
