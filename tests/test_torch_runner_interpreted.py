"""The port's interpreted runner, 3-D segmenter and global linker against
the JAX package's, on the CPU (the compiled runner is in
``tests/test_torch_runner.py``, whose movie and pipeline this file reuses).

- ``compiled: False`` (and ``compiled`` unset, which interprets on the
  CPU): the step-by-step loop, with ``stitch_rois`` trackers and the
  interpreted extraction, against the JAX package's interpreted run: the
  profiles column by column (metadata and integer-valued columns exact,
  float features within ``aliby_tpu_torch.extract.tolerances``) and every
  saved segment and tracker ``.npz`` bit-equal.
- ``dispatch_segmenter("cellpose", three_d=True)`` on a three-plane stack:
  labels bit-equal to JAX's (z planes segmented, stitched at 0.01, max
  projected, relabelled).
- ``build_pipeline_steps(trackastra_parameters=...)`` (no address) attaches the
  in-process ``track_global`` linker; its table equals the JAX package's
  ``link_tracks`` on the same saved masks.
- Without a card, the runner's default device raises: nothing falls back.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aliby_tpu.engine.builders import build_pipeline_steps as jax_build_pipeline_steps
from aliby_tpu.models.segment import dispatch_segmenter as jax_dispatch_segmenter
from aliby_tpu.parallel.positions import stamp_image_kwargs as jax_stamp
from aliby_tpu.pipe import run_pipeline_and_post as jax_run_pipeline_and_post
from aliby_tpu.track.linker import link_tracks as jax_link_tracks
from aliby_tpu_torch.engine import core
from aliby_tpu_torch.engine.builders import build_pipeline_steps
from aliby_tpu_torch.models.segment import dispatch_segmenter
from aliby_tpu_torch.parallel.positions import stamp_image_kwargs
from aliby_tpu_torch.pipe import init_step, run_pipeline_and_post
from aliby_tpu_torch.test_data import cellpainting_movie
from test_torch_runner import (
    NTPS,
    SIZE,
    assert_profiles_match,
    assert_same_bits,
    assert_same_saves,
    runner_pipeline,
    write_movie,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def interpreted(tmp_path_factory):
    root = tmp_path_factory.mktemp("interpreted")
    positions = write_movie(root / "store", n_pos=1)
    jax_pipe = jax_stamp(runner_pipeline(jax_build_pipeline_steps, jnp.float32, compiled=False),
                         positions[0], capture_order="TCZYX")
    out = {"root": root, "jax": jax_run_pipeline_and_post(jax_pipe, "pos0", root / "jax")[0]}
    for name, extra in (("port", dict(compiled=False)), ("unset", {})):
        pipe = stamp_image_kwargs(runner_pipeline(build_pipeline_steps, torch.float32, **extra),
                                  positions[0], capture_order="TCZYX")
        out[name] = run_pipeline_and_post(pipe, "pos0", root / name, device="cpu")[0]
    return out


def test_interpreted_path_matches_jax(interpreted):
    assert_profiles_match(interpreted["port"], interpreted["jax"])
    assert_same_saves(interpreted["root"] / "port" / "steps" / "pos0",
                      interpreted["root"] / "jax" / "steps" / "pos0")


def test_compiled_unset_interprets_on_the_cpu(interpreted):
    assert_same_bits(interpreted["unset"], interpreted["port"])
    assert not core._should_compile({}, "cpu") and core._should_compile({"compiled": True}, "cpu")


def test_three_d_segmenter_matches_jax():
    movie = cellpainting_movie(1, 3, SIZE, seed=5, n_cells=8).astype(np.float32)
    stack = np.moveaxis(movie[0, :, :, 0], 0, 1)[None]  # (F=1, C, Z=3, Y, X): tps as planes
    for channel, second in ((0, 3), (3, None)):
        kw = dict(three_d=True, second_channel=second)
        want = jax_dispatch_segmenter("cellpose", channel, model_kwargs={"dtype": jnp.float32},
                                      **kw)(stack)
        seg = dispatch_segmenter("cellpose", channel, model_kwargs={"dtype": torch.float32},
                                 device="cpu", **kw)
        got = seg(stack)
        assert len(got) == 1 and got[0].dtype == np.uint16
        np.testing.assert_array_equal(got[0], want[0])
        assert got[0].max() > 0


def test_global_linker_matches_jax(tmp_path):
    positions = write_movie(tmp_path / "store", n_pos=1)
    pipe = build_pipeline_steps(channels_to_segment={"nuclei": 0}, channels_to_extract=[0],
                                features_to_extract=(), trackastra_parameters={})
    assert pipe["global_steps"] == {"track_global": {"parameters": {}}}
    pipe = stamp_image_kwargs(dict(pipe, ntps=NTPS), positions[0], capture_order="TCZYX")
    _, post = run_pipeline_and_post(pipe, "pos0", tmp_path / "out", device="cpu")
    table = post["track_global_nuclei"]
    masks = core.get_step_output({}, ["from_disk:segment_nuclei"],
                                 steps_dir=tmp_path / "out" / "steps" / "pos0")
    assert masks.shape == (1, NTPS, 1, SIZE, SIZE)
    assert table.equals(jax_link_tracks(masks[0]))
    assert (tmp_path / "out" / "track_global" / "pos0_track_global_nuclei.parquet").exists()
    remote = build_pipeline_steps(channels_to_segment={"nuclei": 0},
                                  trackastra_address="tcp://localhost:1")
    assert remote["global_steps"] == {"nahual_trackastra": {"address": "tcp://localhost:1",
                                                            "parameters": {}}}
    assert remote["global_passed_data"] == {
        "nahual_trackastra_nuclei": ("from_disk:segment_nuclei",)}


def test_the_default_device_never_falls_back(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        core.run_pipeline_return_state(runner_pipeline(build_pipeline_steps, torch.float32),
                                       tmp_path, init_step)
