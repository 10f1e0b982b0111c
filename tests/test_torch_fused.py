"""Port parity: the fused step (``aliby_tpu_torch.engine``) against
``aliby_tpu.engine.fused.compile_fused_step``.

- The example-01 configuration (cellpose for ``nuclei`` and ``cell``,
  intensity + sizeshape with edges off, the coloc tree), cut to 3 of its 5
  channels (3 channel pairs; the families are the same per channel), on 2
  Cell Painting look-alike fields of 96x96, bundled weights, f32 model on
  both sides, tree width 16 of max_labels 32: labels bit-equal, feature
  names equal, values within the tolerances of
  ``aliby_tpu_torch.extract.tolerances`` (as ``test_torch_features.py``;
  costes/costes_2 may differ on at most 5% of the objects, at least 1).
- The default bank of ``build_pipeline_steps`` (radial_zernikes, intensity with edges,
  feret, texture, radial_distribution, zernike, plus sizeshape and the
  coloc tree) on the same fields, cut to 2 of the 5 channels: labels
  bit-equal, names equal, values within the same tolerances (the Haralick
  and zernike rules of ``tolerances`` included); the zernike entries go
  through the shared ``zernike_family_multi`` pass on both sides. On the
  objects whose minimum enclosing circle the reference's f32 search misses
  (at most 10% here), the zernike columns are held to the reference's
  arithmetic fed with the port's circle (see ``test_torch_texture.py``), so
  every object is compared in every column.
- The default bank's full 5-channel column set, of the JAX package and of
  the port, equals ``tests/golden/default_bank_columns.txt``.
- The sticky width/uint8 state over a narrow -> overflow -> wide -> narrow
  sequence on a stub segmenter (fixed label maps): shapes, labels and
  values equal at each call.
- The full 5-channel example-01 column set of the port equals the golden
  anchor ``tests/golden/example01_columns.txt`` minus its 4 metadata columns.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aliby_tpu.engine.builders import build_pipeline_steps as jax_build
from aliby_tpu.engine.fused import FusedObject as JaxObject
from aliby_tpu.engine.fused import compile_fused_step as jax_compile
from aliby_tpu.models.segment import dispatch_segmenter as jax_dispatch
from aliby_tpu.test_data import render_cells, render_dense_cells
from aliby_tpu_torch.engine import builders, compiled
from aliby_tpu_torch.engine.fused import FusedObject, compile_fused_step, results_from_fused
from aliby_tpu_torch.models.segment import dispatch_segmenter
from test_torch_features import check_feature
from test_torch_texture import reference_finds_the_circle, reference_on_the_ports_circle

torch.set_num_threads(1)
EXAMPLE01 = dict(channels_to_segment={"nuclei": 0, "cell": 3},
                 features_to_extract=("intensity", "sizeshape"),
                 cp_measure_feature_kwargs={"intensity": {"edge_measurements": False}})
GOLDEN = Path(__file__).parent / "golden" / "example01_columns.txt"
GOLDEN_DEFAULT = Path(__file__).parent / "golden" / "default_bank_columns.txt"
DEFAULT_BANK = dict(channels_to_segment={"nuclei": 0, "cell": 3})


def _fields(n=2, size=96, seed=3):
    rng = np.random.default_rng(seed)
    fields = []
    for _ in range(n):
        cells, nuclei, _ = render_cells(size, 8, rng)
        noise = lambda: rng.normal(0.02, 0.01, (size, size)).astype(np.float32)  # noqa: E731
        ring = np.clip(cells - nuclei, 0, None)
        fields.append(np.stack([nuclei + noise(), ring + noise(),
                                0.5 * nuclei + 0.5 * cells + noise(), cells + noise(),
                                ring * 0.8 + noise()]))
    return np.stack(fields)[:, :, None].astype(np.float32)  # (F, C, Z, Y, X)


def _trees(pipeline, obj):
    steps = pipeline["steps"]
    return [(steps[n]["tree"], steps[n]["kwargs"].get("cp_measure_kwargs"))
            for n in (f"extract_{obj}", f"extractmulti_{obj}")]


def _zernike_on_the_ports_circle(instructions, names, labels, pixels, max_labels):
    """{row: (F, L) values} for the zernike-family rows of one feature
    block: the reference's arithmetic fed with the port's minimum enclosing
    circle, on the step's own labels and z-reduced channel images."""
    if not any("Zernike_" in name for name in names):
        return {}  # the coloc block
    channels = sorted({ch for ch, _, fam in instructions if fam == "radial_zernikes"})
    on_mask, on_imgs = reference_on_the_ports_circle(
        labels.astype(np.int32), pixels[:, channels].max(axis=2), True, max_labels)
    rows = {}
    for i, name in enumerate(names):
        entry, feat = name.split("::", 1)
        if "Zernike_" in feat:
            ch, _, fam = instructions[int(entry)]
            n, m = map(int, feat.split("_")[1:])
            rows[i] = (on_mask if fam == "zernike" else on_imgs[channels.index(ch)])[(n, m)]
    return rows


def _compare_features(got, want, on_circle=None):
    """``on_circle``: per object and feature block, ``(found, rows)``: the
    (F, L) mask of the objects whose minimum enclosing circle the reference
    finds, and ``_zernike_on_the_ports_circle``'s rows, which stand in for
    the reference's on the other objects (see ``test_torch_texture.py``)."""
    for oi, (obj_got, obj_want) in enumerate(zip(got, want)):
        for ti, ((names, arr), (w_names, w_arr)) in enumerate(zip(obj_got, obj_want)):
            assert names == w_names
            w_arr = np.array(w_arr)
            assert arr.shape == w_arr.shape
            if on_circle is not None:
                found, rows = on_circle[oi][ti]
                shape = found.shape
                for i, values in rows.items():
                    np.testing.assert_array_equal(np.isnan(arr[i]), np.isnan(w_arr[i]))
                    part = w_arr[i][:shape[0], :shape[1]]
                    part[...] = np.where(found, part, values)
            row = {name: i for i, name in enumerate(names)}
            for i, name in enumerate(names):
                entry, feat = name.split("::", 1)

                def ref(other, entry=entry):
                    return w_arr[row[f"{entry}::{other}"]]

                check_feature(feat, arr[i], w_arr[i], ref)


def _both_steps(kw):
    """The JAX and the port's fused step of one ``build_pipeline_steps`` configuration (f32
    models, tree width 16 of max_labels 32), each run on the test fields."""
    pixels = _fields()
    jp, tp = jax_build(**kw), builders.build_pipeline_steps(**kw)
    f32 = {"dtype": jnp.float32}
    jn = jax_dispatch("cellpose", 0, second_channel=3, model_kwargs=f32)
    jc = jax_dispatch("cellpose", 3, second_channel=0, model_kwargs=f32)
    jstep = jax_compile([JaxObject(jn.engine, 0, 3, _trees(jp, "nuclei")),
                         JaxObject(jc.engine, 3, 0, _trees(jp, "cell"))],
                        max_labels=32, out_labels_cap=16)
    t32 = {"dtype": torch.float32}
    tn = dispatch_segmenter("cellpose", 0, second_channel=3, model_kwargs=t32, device="cpu")
    tc = dispatch_segmenter("cellpose", 3, second_channel=0, model_kwargs=t32, device="cpu")
    tstep = compile_fused_step([FusedObject(tn.engine, 0, 3, _trees(tp, "nuclei")),
                                FusedObject(tc.engine, 3, 0, _trees(tp, "cell"))],
                               max_labels=32, out_labels_cap=16)
    return pixels, jstep, jstep(pixels), tstep, tstep(pixels)


@pytest.fixture(scope="module")
def example01():
    return _both_steps(dict(EXAMPLE01, channels_to_extract=[0, 1, 3]))


def test_default_bank_matches_jax():
    pixels, _, want, tstep, got = _both_steps(dict(DEFAULT_BANK, channels_to_extract=[1, 3]))
    for g, w in zip(got["labels"], want["labels"]):
        np.testing.assert_array_equal(g, w)
    # mono tree: 78 sizeshape + 2 feret + 30 zernike + 2 channels x (21 intensity +
    # 52 texture + 12 radial_distribution + 30 radial_zernikes); coloc: 1 pair x 8
    assert [[a.shape for _, a in o] for o in got["features"]] == [[(340, 2, 16), (8, 2, 16)]] * 2
    on_circle = []
    for oi, lab in enumerate(got["labels"]):
        found = reference_finds_the_circle(lab.astype(np.int32), 16)
        on_circle.append([(found, _zernike_on_the_ports_circle(
            tstep.plans[oi][ti][0], names, lab, pixels, 16))
            for ti, (names, _) in enumerate(got["features"][oi])])
    assert sum(len(rows) for _, rows in on_circle[0]) == 90  # 30 zernike + 2 x 30 radial
    _compare_features(got["features"], want["features"], on_circle)
    assert tstep.state == {"cap": 16, "u8": True}


def _column_set(plans, out):
    columns = set()
    for ti, (names, arr) in enumerate(out["features"][0]):
        res = results_from_fused(plans[0][ti], names, arr, out["labels"][0])
        columns |= set(res.columns()) - {"tile", "label"}
    return columns


def test_default_bank_column_set_is_the_golden_anchor():
    """One name set for the JAX package's plans and the port's step: the
    names of a family do not depend on the pixels, so the JAX side names its
    columns from the port's feature block through its own plans and
    ``FusedTreeResult``."""
    from aliby_tpu.engine.fused import results_from_fused as jax_results
    from aliby_tpu.extract.extract import compile_plan as jax_plan
    from aliby_tpu.extract.extract import flatten as jax_flatten
    from aliby_tpu.extract.extract import kv as jax_kv

    kw = dict(DEFAULT_BANK, channels_to_extract=[0, 1, 2, 3, 4])
    step = compiled.try_compile(builders.build_pipeline_steps(**kw), device="cpu")
    out = step.fused(_fields(n=1, size=64, seed=5))
    golden = set(GOLDEN_DEFAULT.read_text().splitlines())
    assert len(golden) == 893 and _column_set(step.fused.plans, out) == golden
    jax_columns = set()
    for (tree, cpkw), (names, arr) in zip(_trees(jax_build(**kw), "nuclei"), out["features"][0]):
        instructions = jax_kv(jax_flatten(tree))
        plan = (instructions, *jax_plan(instructions, cpkw or {}))
        jax_columns |= set(jax_results(plan, names, arr, out["labels"][0]).to_table().column_names)
    assert jax_columns - {"tile", "label"} == golden


def test_example01_matches_jax(example01):
    pixels, jstep, want, tstep, got = example01
    assert len(got["labels"]) == 2
    for g, w in zip(got["labels"], want["labels"]):
        assert g.shape == (2, 96, 96) and g.dtype == np.int32
        assert 3 <= w.max() <= 16
        np.testing.assert_array_equal(g, w)
    # mono tree: 78 sizeshape + 3 x 16 intensity; coloc: 3 pairs x 8
    assert [[a.shape for _, a in o] for o in got["features"]] == [[(126, 2, 16), (24, 2, 16)]] * 2
    _compare_features(got["features"], want["features"])
    assert tstep.state == {"cap": 16, "u8": True}


def test_results_from_fused_rows_and_columns(example01):
    pixels, jstep, want, tstep, got = example01
    from aliby_tpu.engine.fused import results_from_fused as jax_results

    for ti in range(2):
        res = results_from_fused(tstep.plans[0][ti], *got["features"][0][ti], got["labels"][0])
        ref = jax_results(jstep.plans[0][ti], *want["features"][0][ti], want["labels"][0])
        insts, rows = res
        assert insts == ref.tileid_instructions
        assert len(rows) == len(ref[1])
        cols = res.columns()
        table = ref.to_table()
        assert list(cols) == table.column_names
        np.testing.assert_array_equal(cols["label"], table.column("label").to_numpy())
        assert res.to_table().column_names == table.column_names


def test_example01_column_set_is_the_golden_anchor():
    pipeline = builders.build_pipeline_steps(**EXAMPLE01, channels_to_extract=[0, 1, 2, 3, 4])
    step = compiled.try_compile(pipeline, device="cpu")
    assert step.seg_names == ["segment_nuclei", "segment_cell"]
    assert step.ext_of_seg == {"segment_nuclei": ["extract_nuclei", "extractmulti_nuclei"],
                               "segment_cell": ["extract_cell", "extractmulti_cell"]}
    assert compiled.try_compile(pipeline, device="cpu") is step  # cached per signature
    out = step.fused(_fields(n=1, size=64, seed=5))
    golden = {c for c in GOLDEN.read_text().splitlines() if not c.startswith("metadata_")}
    assert len(golden) == 628 and _column_set(step.fused.plans, out) == golden


class _JaxStub:
    """Fixed label maps through the params, so one compiled step serves
    every call (``_segment_all(params, images)``)."""

    params = None

    def _segment_all(self, params, images):
        return params["labels"]


class _TorchStub:
    device = torch.device("cpu")
    labels = None

    def _segment_all(self, images):
        return self.labels


def test_sticky_width_and_uint8_match_jax():
    rng = np.random.default_rng(9)
    sparse = np.stack([render_cells(160, 6, rng)[2] for _ in range(2)])
    medium = np.stack([render_dense_cells(160, 60, rng, 3.0, 6.0) for _ in range(2)])
    dense = np.stack([render_dense_cells(160, 320, rng, 1.8, 3.0) for _ in range(2)])
    assert sparse.max() <= 16 < medium.max() <= 255 < dense.max() <= 400
    yy, xx = np.mgrid[0:160, 0:160] / 160.0
    wave = (np.sin(11 * xx) * np.cos(9 * yy)) ** 2  # intensities vary inside every object
    pixels = np.stack([0.2 + wave + 0.1 * np.arange(2)[:, None, None],
                       0.3 + wave[::-1].repeat(1, 0)[None].repeat(2, 0)], axis=1)
    pixels = pixels[:, :, None].astype(np.float32)  # (F=2, C=2, Z=1, Y, X)
    tree = [({"None": {"None": ("feret",)}, 0: {"max": ["intensity"]}}, None)]
    jstub, tstub = _JaxStub(), _TorchStub()
    jstep = jax_compile([JaxObject(jstub, 0, 1, tree)], max_labels=400, out_labels_cap=16)
    tstep = compile_fused_step([FusedObject(tstub, 0, 1, tree)], max_labels=400,
                               out_labels_cap=16)
    seen = []
    for labels in (sparse, medium, dense, sparse):
        jstub.params = {"labels": jnp.asarray(labels.astype(np.int32))}
        tstub.labels = torch.from_numpy(labels.astype(np.int32))
        want, got = jstep(pixels), tstep(pixels)
        np.testing.assert_array_equal(got["labels"][0], labels)
        np.testing.assert_array_equal(got["labels"][0], want["labels"][0])
        _compare_features(got["features"], want["features"])
        seen.append((got["features"][0][0][1].shape[-1], dict(tstep.state)))
    assert seen == [(16, {"cap": 16, "u8": True}), (400, {"cap": 400, "u8": True}),
                    (400, {"cap": 400, "u8": False}), (400, {"cap": 400, "u8": False})]


def test_try_compile_takes_no_runner_arguments():
    """The reference's positional ``tiler`` and ``init_step_fn`` (the
    runner's call) are accepted and unused: the fused step needs neither,
    and the cache key stays (pipeline signature, device)."""
    pipeline = builders.build_pipeline_steps(**EXAMPLE01, channels_to_extract=[0])
    step = compiled.try_compile(pipeline, device="cpu")
    assert compiled.try_compile(pipeline, object(), lambda *a, **k: None, device="cpu") is step
    with pytest.raises(TypeError):
        compiled.try_compile(pipeline, None, None, "cpu")  # device is keyword-only
