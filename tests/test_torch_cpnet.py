"""Port parity: torch Cellpose checkpoints (``aliby_tpu_torch.models.cpnet``)
against ``aliby_tpu.models.cpnet`` and the compiled runner with a CPnet
engine against the JAX package's.

Weights are seeded state_dicts in the published key layout, both ways:
``test_data.cpnet_state_dict`` (numpy-seeded, the head scaled so that
masks form) and the torch reference graph ``_CPnetTorch`` of
``tests/test_cpnet_port.py`` at its random initialisation; and flax
parameters carried across with ``cpnet_state_dict_from_flax``.

Tolerances (``aliby_tpu_torch.extract.tolerances``):
- the forward, f32: atol 2e-4 of max(1, the output's largest |value|),
  the style atol 2e-4 (``tests/test_cpnet_port.py``'s bound);
- bf16: the U-Net's bf16 rule (max |diff| <= 5%, mean <= 0.5% of the
  largest |value|);
- labels of the cpnet segmenter and of the compiled step: bit-equal to JAX
  (QC on and off, ``flow_iters`` 8); features within the parity tolerances.
"""

import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from aliby_tpu.engine.builders import build_pipeline_steps as jax_build
from aliby_tpu.engine.compiled import try_compile as jax_try_compile
from aliby_tpu.models.cpnet import CPnetFlax, convert_torch_state_dict
from aliby_tpu.models.cpnet import load_cellpose_checkpoint as jax_load
from aliby_tpu.models.segment import CellposeTPU
from aliby_tpu_torch.engine import builders, compiled
from aliby_tpu_torch.extract.tolerances import within_model_tolerance
from aliby_tpu_torch.models.cpnet import (
    CPnet,
    cpnet_state_dict_from_flax,
    load_cellpose_checkpoint,
    tf32_off,
)
from aliby_tpu_torch.models.segment import CellposeTorch, dispatch_segmenter
from aliby_tpu_torch.parallel.pipeline_mesh import run_positions_mesh
from aliby_tpu_torch.parallel.positions import stamp_image_kwargs
from aliby_tpu_torch.pipe import run_pipeline_and_post
from aliby_tpu_torch.test_data import cellpainting_fields, cpnet_state_dict

sys.path.insert(0, str(Path(__file__).parent))
from test_cpnet_port import _CPnetTorch  # noqa: E402
from test_torch_fused import _compare_features  # noqa: E402
from test_torch_runner import assert_same_bits, write_movie  # noqa: E402

torch.set_num_threads(1)
NBASE = (2, 16, 32, 64)  # the reference test's pyramid: the cyto topology, narrower
CYTO = (2, 32, 64, 128, 256)


_FLAX = {}


def _flax_apply(nbase, params, x, dtype=jnp.float32):
    """``CPnetFlax(nbase, dtype).apply``, jitted once per configuration."""
    key = (tuple(nbase), dtype)
    if key not in _FLAX:
        _FLAX[key] = jax.jit(CPnetFlax(nbase=tuple(nbase), dtype=dtype).apply)
    return _FLAX[key](params, x)


def _torch_graph(nbase, seed=0):
    torch.manual_seed(seed)
    model = _CPnetTorch(nbase=nbase)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.3)
                m.running_var.uniform_(0.5, 1.5)
    return model.eval()


def _port(sd, nbase, dtype=torch.float32):
    model = CPnet(nbase=nbase, dtype=dtype)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def _forward(model, x):
    with torch.no_grad():
        out, style = model(torch.from_numpy(x))
    return out.numpy(), style.numpy()


@pytest.mark.parametrize("nbase, source", [(NBASE, "graph"), (NBASE, "seeded"),
                                           (CYTO, "graph"), (CYTO, "seeded")])
def test_forward_matches_the_torch_graph_and_jax(nbase, source):
    x = np.random.default_rng(1).normal(size=(2, 32, 48, 2)).astype(np.float32)
    graph = _torch_graph(nbase)
    sd = graph.state_dict() if source == "graph" else cpnet_state_dict(3, nbase=nbase)
    out, style = _forward(_port(sd, nbase), x)
    assert out.shape == (2, 32, 48, 3) and style.shape == (2, nbase[-1])
    if source == "graph":
        with torch.no_grad():
            t_out, t_style = graph(torch.from_numpy(x.transpose(0, 3, 1, 2)))
        assert within_model_tolerance(out, t_out.numpy().transpose(0, 2, 3, 1), "cpnet")
        assert within_model_tolerance(style, t_style.numpy(), "cpnet")
    f_out, f_style = _flax_apply(nbase, convert_torch_state_dict(sd, nbase), x)
    assert within_model_tolerance(out, np.asarray(f_out), "cpnet")
    np.testing.assert_allclose(style, np.asarray(f_style), atol=2e-4)
    with torch.no_grad():
        only = _port(sd, nbase)(torch.from_numpy(x), style_only=True).numpy()
    np.testing.assert_array_equal(only, style)


def test_state_dict_from_flax_both_ways():
    sd = cpnet_state_dict(0, nbase=NBASE)
    params = jax.tree_util.tree_map(np.asarray, convert_torch_state_dict(sd, NBASE))
    back = cpnet_state_dict_from_flax(params)
    assert list(back) == list(CPnet(nbase=NBASE).state_dict())
    for k, v in sd.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    # flax parameters of a fresh flax init, carried to the port
    x = np.random.default_rng(2).normal(size=(2, 32, 48, 2)).astype(np.float32)
    flax_params = jax.jit(CPnetFlax(nbase=NBASE).init)(jax.random.PRNGKey(5), x)
    flax_params = jax.tree_util.tree_map(np.asarray, flax_params)
    out, style = _forward(_port(cpnet_state_dict_from_flax(flax_params), NBASE), x)
    f_out, f_style = _flax_apply(NBASE, flax_params, x)
    assert within_model_tolerance(out, np.asarray(f_out), "cpnet")
    np.testing.assert_allclose(style, np.asarray(f_style), atol=2e-4)


@pytest.mark.parametrize("wrap", [None, "state_dict", "model_state_dict"])
def test_load_cellpose_checkpoint(tmp_path, wrap):
    sd = cpnet_state_dict(1, nbase=NBASE)
    saved = dict(sd, diam_mean=torch.tensor([30.0]), diam_labels=torch.tensor([17.5]),
                 mkldnn_flag=torch.tensor([0]))
    if wrap:
        saved = {wrap: saved, "epoch": 3}
    path = tmp_path / "cytotorch_0"
    torch.save(saved, path)
    model = load_cellpose_checkpoint(path, nbase=NBASE)
    assert not model.training
    x = np.random.default_rng(3).normal(size=(2, 32, 48, 2)).astype(np.float32)
    out, _ = _forward(model, x)
    np.testing.assert_array_equal(out, _forward(_port(sd, NBASE), x)[0])
    jax_model, params = jax_load(path, nbase=NBASE)
    assert jax_model.nbase == NBASE
    assert within_model_tolerance(out, np.asarray(_flax_apply(NBASE, params, x)[0]), "cpnet")


def test_checkpoints_that_need_pickles_or_are_flax_are_refused(tmp_path):
    import argparse

    from flax import serialization

    sd = cpnet_state_dict(1, nbase=NBASE)
    pickled = tmp_path / "cyto_pickled.pth"
    torch.save({"state_dict": sd, "args": argparse.Namespace(lr=0.1)}, pickled)
    with pytest.raises(ValueError, match="weights_only"):
        load_cellpose_checkpoint(pickled, nbase=NBASE)
    # a flax msgpack of the same weights (scripts/port_cellpose_weights.py's
    # output): the reference's arch="cpnet" route sends it to torch.load and
    # fails; the port refuses it with the same error as any non-torch file
    msgpack = tmp_path / "cellpose_cyto.msgpack"
    params = jax.tree_util.tree_map(np.asarray, convert_torch_state_dict(sd, NBASE))
    msgpack.write_bytes(serialization.to_bytes(params))
    with pytest.raises(Exception):
        CellposeTPU(pretrained_path=msgpack, model_kwargs={"arch": "cpnet", "nbase": NBASE})
    with pytest.raises(ValueError, match="weights_only"):
        CellposeTorch(pretrained_path=msgpack, model_kwargs={"arch": "cpnet", "nbase": NBASE},
                      device="cpu")


@pytest.mark.parametrize("caller", [True, False])
def test_tf32_off_holds_while_any_thread_is_inside(caller):
    """Thread A enters, B enters, A leaves while B runs: the flag stays off
    for B, and the caller's value comes back once both have left."""
    cudnn = torch.backends.cudnn
    saved = cudnn.allow_tf32
    cudnn.allow_tf32 = caller
    a_in, b_in, a_out = threading.Event(), threading.Event(), threading.Event()
    seen = {}

    def a():
        with tf32_off():
            a_in.set()
            b_in.wait(5)
            seen["a"] = cudnn.allow_tf32
        a_out.set()

    def b():
        a_in.wait(5)
        with tf32_off():
            b_in.set()
            a_out.wait(5)
            seen["b after a left"] = cudnn.allow_tf32

    try:
        threads = [threading.Thread(target=f) for f in (a, b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        assert seen == {"a": False, "b after a left": False}
        assert cudnn.allow_tf32 is caller
    finally:
        cudnn.allow_tf32 = saved


def test_bf16_forward_within_the_unet_rule():
    sd = cpnet_state_dict(2, nbase=NBASE)
    x = np.random.default_rng(4).normal(size=(2, 32, 48, 2)).astype(np.float32)
    out, _ = _forward(_port(sd, NBASE, torch.bfloat16), x)
    f_out, _ = _flax_apply(NBASE, convert_torch_state_dict(sd, NBASE), x, jnp.bfloat16)
    assert out.dtype == np.float32
    assert within_model_tolerance(out, np.asarray(f_out), "bf16")


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("cpnet") / "cyto_seeded.pth"
    torch.save(cpnet_state_dict(0, nbase=NBASE), path)
    return path


def _images(n=2, size=96):
    pix = np.concatenate(cellpainting_fields(n, size, seed=7))
    return pix, np.stack([pix[:, 3, 0], pix[:, 0, 0]], 1).astype(np.float32)


@pytest.mark.parametrize("flow_threshold", [0.4, None])
def test_cpnet_segmenter_matches_cellpose_tpu(checkpoint, flow_threshold):
    _, imgs = _images()
    kw = dict(pretrained_path=checkpoint, model_kwargs={"nbase": NBASE},
              flow_threshold=flow_threshold)
    want_engine = CellposeTPU(**kw)
    engine = CellposeTorch(device="cpu", **kw)
    assert engine.flow_iters == want_engine.flow_iters == 8
    got, want = engine.segment_tiles(imgs), want_engine.segment_tiles(imgs)
    for g, w in zip(got, want):
        assert g.dtype == np.uint16
        np.testing.assert_array_equal(g, w)
    if flow_threshold is None:
        assert min(int(g.max()) for g in got) >= 10


def test_cpnet_at_the_cyto_width_matches_cellpose_tpu(tmp_path):
    path = tmp_path / "cyto_seeded.pth"
    torch.save(cpnet_state_dict(0), path)
    _, imgs = _images(1, 64)
    kw = dict(pretrained_path=path, flow_threshold=None)
    got = CellposeTorch(device="cpu", **kw).segment_tiles(imgs)
    want = CellposeTPU(**kw).segment_tiles(imgs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert min(int(g.max()) for g in got) > 0


def _cpnet_pipeline(build, checkpoint, **extra):
    pipeline = build(channels_to_segment={"cell": 3}, channels_to_extract=[0, 3],
                     features_to_extract=(),
                     segmenter_extra_kwargs={"pretrained_path": str(checkpoint),
                                             "model_kwargs": {"nbase": NBASE},
                                             "flow_threshold": None})
    pipeline.update(extra)
    return pipeline


def test_cpnet_step_through_try_compile_matches_jax(checkpoint):
    pix, _ = _images()
    pipeline = _cpnet_pipeline(builders.build_pipeline_steps, checkpoint)
    step = compiled.try_compile(pipeline, device="cpu")
    assert step is not None
    seg = pipeline["steps"]["segment_cell"]["segmenter_kwargs"]
    engine = dispatch_segmenter(channel_to_segment=3, device="cpu", **seg).engine
    assert isinstance(engine.model, CPnet) and engine.flow_iters == 8  # the step's engine
    jstep = jax_try_compile(_cpnet_pipeline(jax_build, checkpoint), None, None)
    got, want = step.fused(pix), jstep.fused(pix)
    for g, w in zip(got["labels"], want["labels"]):
        np.testing.assert_array_equal(g, w)
        assert g.max() > 0
    _compare_features(got["features"], want["features"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory, checkpoint):
    """One position x 4 tps of 96^2 through the port's per-tp, movie
    (chunk 3) and mesh (chunk 3) paths, the CPnet engine, segment saves."""
    root = tmp_path_factory.mktemp("cpnet_runner")
    positions = write_movie(root / "store", n_pos=1)
    saves = dict(save=["segment_cell"], ntps=4, compiled=True)
    out = {"root": root}
    for name, extra in (("per_tp", dict(movie=False)), ("movie", dict(movie_chunk=3))):
        pipe = stamp_image_kwargs(_cpnet_pipeline(builders.build_pipeline_steps, checkpoint,
                                                  **saves, **extra),
                                  positions[0], capture_order="TCZYX")
        out[name] = run_pipeline_and_post(pipe, "pos0", root / name, device="cpu")[0]
    mesh = run_positions_mesh(_cpnet_pipeline(builders.build_pipeline_steps, checkpoint, **saves),
                              positions, root / "mesh", capture_order="TCZYX", device="cpu",
                              chunk=3)
    out["mesh"] = mesh["pos0"][0]
    return out


@pytest.mark.parametrize("path", ["movie", "mesh"])
def test_cpnet_movie_and_mesh_are_the_per_tp_bits(runs, path):
    root = runs["root"]
    assert runs["per_tp"].num_rows > 0
    assert_same_bits(runs[path], runs["per_tp"])
    files = sorted(p.relative_to(root / "per_tp") for p in (root / "per_tp").rglob("*.npz"))
    assert len(files) == 4
    assert files == sorted(p.relative_to(root / path) for p in (root / path).rglob("*.npz"))
    for f in files:
        with np.load(root / path / f) as x, np.load(root / "per_tp" / f) as y:
            assert all(np.array_equal(x[k], y[k]) for k in x.keys()), (path, f)
