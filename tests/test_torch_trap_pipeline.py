"""``tests/test_trap_pipeline.py::test_trap_compiled_multitile_global_tracking``
through the port on the CPU: trap tiles (F = 9 traps) through the compiled
runner with the cellpose kind (f32 U-Net on both sides), cellfuns in the
fused step, the per-tile saves and the in-process ``track_global`` table:
profiles, saves and the tracking table equal to the JAX package's, and
every trap's cell tracked over the 3 tps under one track id.
"""

import numpy as np
import pyarrow.parquet as pq
import torch

from aliby_tpu.pipe import run_pipeline_and_post as jax_run
from aliby_tpu_torch.io import zarrlite
from aliby_tpu_torch.pipe import run_pipeline_and_post
from test_torch_traps import assert_same_tables, trap_movie, trap_pipeline

torch.set_num_threads(1)


def test_trap_compiled_multitile_global_tracking(tmp_path):
    import jax.numpy as jnp

    zarrlite.write_array(tmp_path / "posM", trap_movie(3, 7, "ellipse"))

    def pipe(dtype):
        return trap_pipeline(
            tmp_path / "posM", "posM",
            {"kind": "cellpose", "min_size": 10, "model_kwargs": {"dtype": dtype}},
            save=["segment_cell", "track_global"], retain={"segment_cell": 2, "tile": 1},
            ntps=3, compiled=True, global_steps={"track_global": {"parameters": {}}},
            global_passed_data={"track_global_cell": ("from_disk:segment_cell",)})

    from aliby_tpu_torch.engine.compiled import try_compile

    assert try_compile(pipe(torch.float32), device="cpu") is not None  # not interpreted
    got, _ = run_pipeline_and_post(pipe(torch.float32), "posM", tmp_path / "port",
                                   overwrite=True, device="cpu")
    want, _ = jax_run(pipeline=pipe(jnp.float32), pipeline_name="posM",
                      output_path=tmp_path / "jax", overwrite=True)
    assert_same_tables(got, want)
    tiles = set(got.column("metadata_tile").to_pylist())
    assert len(tiles) == 9
    f = "track_global/posM_track_global_cell.parquet"
    tracks = pq.read_table(tmp_path / "port" / f)
    assert_same_tables(tracks, pq.read_table(tmp_path / "jax" / f))
    tl = tracks.to_pydict()
    for tile in tiles:
        by_track: dict = {}
        for tp, ti, tr in zip(tl["timepoint"], tl["tile"], tl["track_id"]):
            if ti == tile:
                by_track.setdefault(tr, set()).add(tp)
        assert any(len(v) == 3 for v in by_track.values())
    seg_dir = "steps/posM/segment_cell"
    files = sorted((tmp_path / "jax" / seg_dir).glob("*.npz"))
    assert len(files) == 3
    for p in files:
        with np.load(p) as b, np.load(tmp_path / "port" / seg_dir / p.name) as a:
            np.testing.assert_array_equal(a["arr_0"], b["arr_0"])
