"""Example 01 from a TIFF plate, on the CPU: ``chip_smoke.py`` phase 9's path
at 256^2.

The port's example 01 (``build_pipeline_steps`` with intensity and
sizeshape, the cellpose kind with the bundled weights, compiled) on the
port's ``crop_cellpainting_256`` TIFF fixture, found by ``DatasetDir`` and
read through the native decoder, against the JAX package's example 01 on
its own fixture: the profiles parquet column by column, each object's rows
apart (the metadata and integer-valued columns exact, float features within
``aliby_tpu_torch.extract.tolerances``, costes at most 5% of an object's
values, at least one, as ``tests/test_torch_fused.py`` holds each object's
block). The U-Net is f32 on both sides (the runner tests' rule: bf16 labels
differ from JAX's by a few boundary pixels). Every read of the data plane
is a native decode, on both sides: the JAX package's decoder is a library
that only this process builds (``test_torch_native.private_jax_native``; the
JAX package links its own in place, which several workers race for). Most of
the file's time is JAX's compile of the step.
"""

from pathlib import Path

import pyarrow.compute as pc
import pytest
import torch

from aliby_tpu import native as jax_native
from aliby_tpu.engine.builders import build_pipeline_steps as jax_build_pipeline_steps
from aliby_tpu.io.dataset import DatasetDir as JaxDatasetDir
from aliby_tpu.parallel.positions import stamp_image_kwargs as jax_stamp
from aliby_tpu.pipe import run_pipeline_and_post as jax_run_pipeline_and_post
from aliby_tpu.test_data import get_dataset_path as jax_dataset_path
from aliby_tpu_torch import native
from aliby_tpu_torch.engine.builders import build_pipeline_steps
from aliby_tpu_torch.io import image
from aliby_tpu_torch.io.dataset import DatasetDir
from aliby_tpu_torch.parallel.positions import stamp_image_kwargs
from aliby_tpu_torch.pipe import run_pipeline_and_post
from aliby_tpu_torch.test_data import get_dataset, get_dataset_path
from test_torch_native import private_jax_native
from test_torch_runner import assert_profiles_match

torch.set_num_threads(1)

ENTRY = get_dataset("crop_cellpainting_256")


def example01(build, dtype) -> dict:
    pipeline = build(channels_to_segment={"nuclei": 0, "cell": 3},
                     channels_to_extract=[0, 1, 2, 3, 4],
                     features_to_extract=("intensity", "sizeshape"),
                     cp_measure_feature_kwargs={"intensity": {"edge_measurements": False}},
                     segmenter_extra_kwargs={"kind": "cellpose",
                                             "model_kwargs": {"dtype": dtype}})
    pipeline["compiled"] = True
    return pipeline


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("example01")
    with private_jax_native(tmp_path_factory.mktemp("jax_native")), \
            pytest.MonkeyPatch.context() as mp:
        jax_decodes, decode = [], jax_native.tiff_decode

        def jax_counted(path, page=0):
            out = decode(path, page=page)
            jax_decodes.append((path, out is not None))
            return out

        mp.setattr(jax_native, "tiff_decode", jax_counted)
        return _runs(root, jax_decodes)


def _runs(root, jax_decodes) -> dict:
    import jax.numpy as jnp

    regex, order = ENTRY["regex"], ENTRY["capture_order"]
    jax_pos = JaxDatasetDir(jax_dataset_path(ENTRY["name"]), regex=regex,
                            capture_order=order).get_position_ids()
    positions = DatasetDir(get_dataset_path(ENTRY["name"]), regex=regex,
                           capture_order=order).get_position_ids()
    assert [p["key"] for p in positions] == [p["key"] for p in jax_pos] == ["A01__1"]
    out = {"positions": positions}
    jax_pipe = jax_stamp(example01(jax_build_pipeline_steps, jnp.float32), jax_pos[0],
                         regex=regex, capture_order=order)
    out["jax"] = jax_run_pipeline_and_post(jax_pipe, "A01__1", root / "jax")[0]
    out["jax_decodes"] = list(jax_decodes)
    reads, read = [], image._read_image_file

    def counted(path):
        reads.append(path)
        return read(path)

    before = native.decodes
    image._read_image_file = counted
    try:
        pipe = stamp_image_kwargs(example01(build_pipeline_steps, torch.float32), positions[0],
                                  regex=regex, capture_order=order)
        out["port"] = run_pipeline_and_post(pipe, "A01__1", root / "port", device="cpu")[0]
    finally:
        image._read_image_file = read
    out["reads"], out["decodes"] = reads, native.decodes - before
    return out


def test_example01_from_tiffs_matches_jax(runs):
    port, jax_ = runs["port"], runs["jax"]
    assert port.column("metadata_object").to_pylist() == jax_.column(
        "metadata_object").to_pylist()
    objects = set(port.column("metadata_object").to_pylist())
    assert objects == {"nuclei", "cell"}
    for obj in sorted(objects):
        rows = pc.equal(port.column("metadata_object"), obj)
        assert_profiles_match(port.filter(rows), jax_.filter(rows))
    assert port.num_rows > 10


def test_every_read_is_a_native_decode(runs):
    files = set(runs["positions"][0]["path"])
    assert len(files) == 5 and set(runs["reads"]) == files
    assert runs["decodes"] == len(runs["reads"])
    jax_files = {Path(p).name for p, _ in runs["jax_decodes"]}
    assert jax_files == {Path(p).name for p in files}
    assert all(ok for _, ok in runs["jax_decodes"]), "a JAX read fell back to imageio"
