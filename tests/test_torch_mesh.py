"""Several devices for the port's fused step and runner, on the CPU
(``aliby_tpu_torch.parallel.mesh``, ``engine.fused.ShardedStep``,
``parallel.pipeline_mesh.run_positions_mesh`` over a mesh):

- ``make_mesh``'s shapes, defaults and errors against the JAX package's on
  the 8 virtual CPU devices of ``tests/conftest.py``; ``shard_batch``'s
  blocks against the blocks that JAX's ``batch_sharding`` and
  ``shard_batch`` put on each device.
- The dp-sharded fused step on ``["cpu", "cpu"]`` (example 01's trees, the
  bundled U-Net in f32 without the flow-error QC, tree width 16 of
  max_labels 32, as
  ``tests/test_torch_fused.py`` builds its step), where only one shard's
  field passes 16 objects: its output equals the one-device step's on the
  concatenated batch, bit for bit, and so does the sticky state after (one
  state for all shards: both widened at the same call).
- ``run_positions_mesh`` over dp = 2 (3 positions x 3 tps of 64x64 with
  2, 2 and 3 labels at most, a stitch tracker per object, chunks of 2: shards of 2
  and 1 positions, a ragged last chunk; the fused step's width narrowed to
  2 labels, so that only the second shard passes it) bit-equal to dp = 1
  (profiles, NaN equal to NaN, and every saved segment and tracker
  ``.npz``), both ending wide, and within the runner's rules
  (``tests/test_torch_runner.py``'s ``assert_profiles_match``) of the JAX
  package's ``run_positions_mesh(mesh=make_mesh(8))``.
"""

import threading
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from aliby_tpu.engine.builders import build_pipeline_steps as jax_build_pipeline_steps
from aliby_tpu.parallel import mesh as jax_mesh
from aliby_tpu.parallel.pipeline_mesh import run_positions_mesh as jax_run_positions_mesh
from aliby_tpu_torch.engine import builders, compiled
from aliby_tpu_torch.engine.fused import FusedObject, ShardedStep, compile_fused_step
from aliby_tpu_torch.io import zarrlite
from aliby_tpu_torch.io.dataset import DatasetZarr
from aliby_tpu_torch.kernels import _build
from aliby_tpu_torch.models.segment import dispatch_segmenter
from aliby_tpu_torch.parallel import mesh as port_mesh
from aliby_tpu_torch.parallel import pipeline_mesh
from aliby_tpu_torch.parallel.pipeline_mesh import run_positions_mesh
from aliby_tpu_torch.test_data import cellpainting_movie, render_cells, render_dense_cells
from test_torch_runner import (
    assert_profiles_match,
    assert_same_bits,
    assert_same_saves,
    runner_pipeline,
)

torch.set_num_threads(1)

CPU8 = ["cpu"] * 8


# ---------------------------------------------------------------------------
# make_mesh and shard_batch against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args", [{}, {"n_devices": 4}, {"n_devices": 8, "sp": 2},
                                  {"n_devices": 8, "dp": 2}, {"n_devices": 6, "dp": 3, "sp": 2},
                                  {"n_devices": 1}])
def test_make_mesh_shapes_match_jax(args):
    want = jax_mesh.make_mesh(**args)
    got = port_mesh.make_mesh(devices=CPU8, **args)
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    assert got.devices.shape == want.devices.shape
    assert got.dp_devices == [torch.device("cpu")] * want.shape["dp"]


@pytest.mark.parametrize("args", [{"n_devices": 8, "dp": 3}, {"n_devices": 6, "sp": 4},
                                  {"n_devices": 8, "dp": 2, "sp": 2}])
def test_make_mesh_errors_match_jax(args):
    with pytest.raises(ValueError, match=r"dp\(\d+\) \* sp\(\d+\) != n_devices"):
        jax_mesh.make_mesh(**args)
    with pytest.raises(ValueError, match=r"dp\(\d+\) \* sp\(\d+\) != n_devices"):
        port_mesh.make_mesh(devices=CPU8, **args)


def test_make_mesh_takes_every_card_and_never_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        port_mesh.make_mesh()
    with pytest.raises(ValueError, match="n_devices"):
        port_mesh.make_mesh(3, devices=["cpu", "cpu"])
    repeated = port_mesh.make_mesh(devices=["cpu", "cpu"])
    assert repeated.shape == {"dp": 2, "sp": 1}
    assert port_mesh.batch_sharding(repeated) == ("dp", "sp")
    assert port_mesh.replicated(repeated) == ()


def _jax_blocks(array, sharding, mesh):
    """{(dp, sp) coordinate: the block JAX puts on that device}."""
    placed = jax.device_put(array, sharding)
    where = {d.id: tuple(int(i) for i in np.argwhere(mesh.devices == d)[0])
             for d in mesh.devices.flat}
    return {where[s.device.id]: np.asarray(s.data) for s in placed.addressable_shards}


@pytest.mark.parametrize("dp, sp", [(4, 2), (2, 4), (8, 1)])
def test_shard_batch_blocks_match_jax(dp, sp):
    x = np.arange(8 * 16 * 3, dtype=np.float32).reshape(8, 16, 3)
    jm, pm = jax_mesh.make_mesh(8, dp=dp, sp=sp), port_mesh.make_mesh(8, dp, sp, devices=CPU8)
    by_batch = _jax_blocks(x, jax_mesh.batch_sharding(jm), jm)
    by_dp = _jax_blocks(x, jax.tree_util.tree_leaves(jax_mesh.shard_batch(jm, x))[0].sharding,
                        jm)
    for rank in range(8):
        coords = pm.coords(rank)
        np.testing.assert_array_equal(port_mesh.shard_batch(pm, x, rank, spec=("dp", "sp")),
                                      by_batch[coords])
        np.testing.assert_array_equal(port_mesh.shard_batch(pm, {"x": x}, rank)["x"],
                                      by_dp[coords])
    t = torch.from_numpy(x)
    blocks = [port_mesh.shard_batch(pm, [t], r, spec=("dp", "sp"))[0] for r in range(8)]
    assert all(b._base is t for b in blocks)  # views


def test_shard_batch_uneven_blocks():
    pm = port_mesh.make_mesh(devices=["cpu"] * 4, sp=2)
    x = np.zeros((3, 40, 5))
    shapes = [port_mesh.shard_batch(pm, x, r, spec=("dp", "sp"), unit=8).shape for r in range(4)]
    assert shapes == [(2, 24, 5), (2, 16, 5), (1, 24, 5), (1, 16, 5)]
    with pytest.raises(ValueError, match="multiple of 8"):
        port_mesh.shard_batch(pm, np.zeros((2, 36)), 0, spec=("dp", "sp"), unit=8)


# ---------------------------------------------------------------------------
# the dp-sharded fused step
# ---------------------------------------------------------------------------

SIZE = 96


def _field(n_cells, rng, dense=False):
    """A five-channel field (``tests/test_torch_fused.py``'s layout); dense:
    touching ellipses (``render_dense_cells``) with a soft interior profile
    and nuclei at its crest, ~20 objects where ``render_cells`` fits ~6."""
    if dense:
        labels = render_dense_cells(SIZE, n_cells, rng, rmin=6.0, rmax=9.0)
        cells = np.zeros(labels.shape, np.float32)
        for i in range(1, labels.max() + 1):
            depth = ndimage.distance_transform_edt(labels == i)
            cells += (depth / max(depth.max(), 1.0)).astype(np.float32)
        nuclei = np.where(cells > 0.6, cells, 0).astype(np.float32)
    else:
        cells, nuclei, _ = render_cells(SIZE, n_cells, rng)
    noise = lambda: rng.normal(0.02, 0.01, (SIZE, SIZE)).astype(np.float32)  # noqa: E731
    ring = np.clip(cells - nuclei, 0, None)
    return np.stack([nuclei + noise(), ring + noise(), 0.5 * nuclei + 0.5 * cells + noise(),
                     cells + noise(), ring * 0.8 + noise()])[:, None].astype(np.float32)


def _step():
    pipeline = builders.build_pipeline_steps(
        channels_to_segment={"nuclei": 0, "cell": 3}, channels_to_extract=[0, 3],
        features_to_extract=("intensity", "sizeshape"),
        cp_measure_feature_kwargs={"intensity": {"edge_measurements": False}})
    steps = pipeline["steps"]
    f32 = {"dtype": torch.float32}
    objects = []
    for obj, ch, second in (("nuclei", 0, 3), ("cell", 3, 0)):
        # no flow-error QC: it drops touching objects of the dense field
        seg = dispatch_segmenter("cellpose", ch, second_channel=second, model_kwargs=f32,
                                 flow_threshold=None, device="cpu")
        trees = [(steps[n]["tree"], steps[n]["kwargs"].get("cp_measure_kwargs"))
                 for n in (f"extract_{obj}", f"extractmulti_{obj}")]
        objects.append(FusedObject(seg.engine, ch, second, trees))
    return compile_fused_step(objects, max_labels=32, out_labels_cap=16)


@pytest.fixture(scope="module")
def sharded_vs_one():
    rng = np.random.default_rng(8)
    sparse = np.stack([_field(5, rng), _field(6, rng)])  # shard 0: few objects
    dense = np.stack([_field(40, rng, dense=True)])  # shard 1: past the tree width of 16
    one = _step()
    want = one(np.concatenate([sparse, dense]))
    shards = _step()
    sharded = ShardedStep([shards, shards])
    try:
        got = sharded([sparse, dense])
        launches = [dict(c) for c in sharded.shard_launches]
    finally:
        sharded.close()
    lmax = [[int(lab[:2].max()), int(lab[2:].max())] for lab in want["labels"]]
    return got, want, one.state, sharded.state, shards.state, lmax, launches


def test_sharded_step_is_the_one_device_step(sharded_vs_one):
    got, want, *_ = sharded_vs_one
    assert len(got["labels"]) == len(want["labels"]) == 2
    for g, w in zip(got["labels"], want["labels"]):
        assert g.shape == (3, SIZE, SIZE)
        np.testing.assert_array_equal(g, w)
    for g_obj, w_obj in zip(got["features"], want["features"]):
        for (g_names, g_arr), (w_names, w_arr) in zip(g_obj, w_obj):
            assert g_names == w_names and g_arr.shape == w_arr.shape
            assert np.array_equal(g_arr, w_arr, equal_nan=True)


def test_one_shard_widens_the_shared_state(sharded_vs_one):
    got, _, one_state, state, shard_state, lmax, launches = sharded_vs_one
    # only the dense shard passes the width of 16; both shards ran wide
    assert max(m[0] for m in lmax) <= 16 < max(m[1] for m in lmax)
    assert state == one_state == {"cap": 32, "u8": True}
    assert shard_state == {"cap": 16, "u8": True}  # the shards' own steps are untouched
    assert all(arr.shape[-1] == 32 for obj in got["features"] for _, arr in obj)
    assert launches == [{}, {}]  # CPU tensors launch no kernel


def test_sharded_step_on_one_shard_is_the_fused_step():
    rng = np.random.default_rng(9)
    pixels = np.stack([_field(5, rng)])
    step = _step()
    sharded = ShardedStep([step])
    assert sharded._pool is None and sharded.streams == [None]
    assert sharded.state == step.initial_state and sharded.state is not step.state
    got = sharded([pixels])
    want = _step()(pixels)
    for g, w in zip(got["labels"], want["labels"]):
        np.testing.assert_array_equal(g, w)


def test_launch_counts_from_many_threads():
    """The wrappers count through ``_build.count``: no count is lost when
    many threads count at once, and each thread's tally is its own."""
    def wrapper():
        pass

    wrapper.launches = 0
    tallies = [None] * 16
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            with _build.tally() as counts:
                for _ in range(2000):
                    _build.count(wrapper, 1)
            tallies[i] = counts

        threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == 16 * 2000
    assert tallies == [{"wrapper": 2000}] * 16


# ---------------------------------------------------------------------------
# run_positions_mesh over dp = 2
# ---------------------------------------------------------------------------

NTPS, MESH_SIZE, N_POS = 3, 64, 3
# the fused step's tree width, narrowed for 64x64 fields: of this movie's
# positions only the last has more labels (3) in a field
NARROW = {"cap": 2, "u8": True}


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh")
    movie = cellpainting_movie(N_POS, NTPS, MESH_SIZE, seed=6, n_cells=6)
    for p in range(N_POS):
        zarrlite.write_array(root / "store" / f"pos{p}", movie[p],
                             chunks=(1, 1, 1, MESH_SIZE, MESH_SIZE))
    positions = DatasetZarr(root / "store").get_position_ids()
    port = runner_pipeline(builders.build_pipeline_steps, torch.float32, ntps=NTPS,
                           compiled=True)
    plans, states = [], {}
    real_plan = pipeline_mesh.plan_calls

    def spy(*args):
        plans.append((args, real_plan(*args)))
        return plans[-1][1]

    # a cache of this module's own, so that both runs use the one compiled
    # step whose initial sticky width is narrowed here
    cache = compiled._COMPILED_CACHE.copy()
    compiled._COMPILED_CACHE.clear()
    made, real_compile = [], pipeline_mesh.try_compile_sharded

    def keep(*args):  # the run's sharded step, for its sticky state after
        steps, sharded = real_compile(*args)
        made.append(sharded)
        return steps, sharded

    pipeline_mesh.plan_calls = spy
    pipeline_mesh.try_compile_sharded = keep
    try:
        compiled.try_compile(port, device="cpu").fused.initial_state.update(NARROW)
        for tag, kw in (("dp2", {"mesh": port_mesh.make_mesh(devices=["cpu", "cpu"])}),
                        ("dp1", {"device": "cpu"})):
            made.clear()
            ran = run_positions_mesh(port, positions, root / tag, capture_order="TCZYX",
                                     chunk=2, **kw)
            states[tag] = ran, dict(made[0].state)
    finally:
        pipeline_mesh.try_compile_sharded = real_compile
        pipeline_mesh.plan_calls = real_plan
        compiled._COMPILED_CACHE.clear()
        compiled._COMPILED_CACHE.update(cache)
    out = {tag: ran for tag, (ran, _) in states.items()}
    jax_pipe = runner_pipeline(jax_build_pipeline_steps, jnp.float32, ntps=NTPS, compiled=True)
    out["jax"] = jax_run_positions_mesh(jax_pipe, positions, root / "jax",
                                        capture_order="TCZYX", mesh=jax_mesh.make_mesh(8),
                                        overwrite=True, chunk=2)
    return out, root, positions, plans, {tag: st for tag, (_, st) in states.items()}


def test_mesh_dp2_is_the_dp1_bits(mesh_runs):
    out, root, positions, plans, _ = mesh_runs
    assert [p[0][-1] for p in plans] == [2, 1]  # dp passed to the plan
    assert [p[1] for p in plans] == [(N_POS, 2)] * 2
    for pos in positions:
        key = pos["key"]
        assert_same_bits(out["dp2"][key][0], out["dp1"][key][0])
        assert_same_saves(root / "dp2" / "steps" / key, root / "dp1" / "steps" / key)
        assert set(out["dp2"][key][0].column("metadata_tp").to_pylist()) == set(range(NTPS))


def test_mesh_one_shard_widens_the_shared_width(mesh_runs):
    """Shards of positions (0, 1) and (2): only the second shard's labels
    pass the narrowed width, and both runs end wide."""
    out, root, positions, _, states = mesh_runs
    largest = []
    for pos in positions:
        saves = (root / "dp2" / "steps" / pos["key"]).glob("segment_*/*.npz")
        largest.append(max(int(np.load(f)["arr_0"].max()) for f in saves))
    assert max(largest[:2]) <= NARROW["cap"] < largest[2]
    assert states == {"dp2": {"cap": 256, "u8": True}, "dp1": {"cap": 256, "u8": True}}


def test_mesh_dp2_matches_jax_mesh(mesh_runs):
    out, _, positions, _, _ = mesh_runs
    for pos in positions:
        assert_profiles_match(out["dp2"][pos["key"]][0], out["jax"][pos["key"]][0])


def test_split_positions_and_plan_calls_over_dp():
    assert [list(r) for r in pipeline_mesh._split_positions(3, 2)] == [[0, 1], [2]]
    assert [list(r) for r in pipeline_mesh._split_positions(1, 2)] == [[0], []]
    # 24 positions of 1 tile over 2 shards of 10 fields each: 20 a round, balanced to 12
    assert pipeline_mesh.plan_calls(24, 1, 7, 1, 10, True, 2) == (12, 1)
    assert pipeline_mesh.plan_calls(24, 1, 7, 1, 10, True, 1) == (8, 1)
    # chunk sizing follows the positions a shard's call holds
    assert pipeline_mesh.plan_calls(4, 4, 7, None, None, True, 2) == (4, 4)
    assert pipeline_mesh.plan_calls(4, 4, 7, None, None, True, 1) == (4, 2)
