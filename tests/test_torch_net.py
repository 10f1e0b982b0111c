"""Port parity: the remote model layer (``aliby_tpu_torch.net``) and the
whole-movie linker's numpy columns, against the JAX package.

- Wire frames: the port's encoder gives the JAX package's bytes for mixed
  value trees (arrays of every kind, bytes, nested dicts/lists/tuples,
  numpy scalars), and each decodes the other's frames.
- A JAX client against a port server and a port client against a JAX
  server, on ``ipc://``, for the threshold, embed and trackastra groups:
  the reply frames of the two servers to the same request are the same
  bytes (threshold, trackastra), and the results equal the models run in
  process (masks and tracks exact; embeddings exact against the same
  package's in-process model, and by the bf16 embedding rule across
  packages).
- The session contract (``describe``'s ``impl``, errors, ``ping``).
- A pipeline of ``nahual_cellpose``, ``nahual_spotiflow``, ``nahual_embed``
  and the ``nahual_trackastra`` global step through
  ``run_pipeline_and_post(device="cpu")`` against a port server equals the
  same models in process.
- ``link_tracks_columns`` against the JAX package's ``link_tracks`` table,
  and the ``track_global`` step with pyarrow hidden.
"""

import socket
import struct
import sys

import numpy as np
import pytest
import torch

from aliby_tpu.models.embedder import make_embedder as jax_make_embedder
from aliby_tpu.models.segment import dispatch_segmenter as jax_dispatch
from aliby_tpu.net import client as jax_client
from aliby_tpu.net import wire as jax_wire
from aliby_tpu.net.server import ModelServer as JaxServer
from aliby_tpu.track.linker import link_tracks as jax_link_tracks
from aliby_tpu_torch.extract.tolerances import within_model_tolerance
from aliby_tpu_torch.models.embedder import make_embedder
from aliby_tpu_torch.models.segment import dispatch_segmenter
from aliby_tpu_torch.net import client, wire
from aliby_tpu_torch.net.server import ModelServer
from aliby_tpu_torch.test_data import render_cells
from aliby_tpu_torch.track.linker import TRACK_COLUMNS, link_tracks_columns

torch.set_num_threads(1)

TREES = [
    {"op": "process", "data": np.arange(12, dtype=np.uint16).reshape(3, 4)},
    {"a": b"first-blob", "arr": np.linspace(0, 1, 7), "b": b"",
     "nested": [b"third\x00blob", np.ones((2, 2), np.int8), (4, 5.5, None)]},
    {"masks": [np.zeros((0, 5), np.int32), np.array(3.5, np.float32),
               np.array([[True, False]]), np.arange(6, dtype=">i4").reshape(2, 3)],
     "metadata": {"cell_label": [[1, 2], []], "mother_assign": [[0, 1], []]}},
    {"result": {"timepoint": [0, 1], "centroid_y": [1.25, -0.0], "s": "ünïcode", "flag": True,
                7: "int key", (1, 2): "tuple key"}},
    [1, "two", 3.0, None, False, {"x": [np.float64(0.1), np.uint8(7)]}],
    {"mother_assign": [np.int64(0), np.float32(2.0)]},
]


@pytest.mark.parametrize("tree", TREES, ids=range(len(TREES)))
def test_wire_frames_are_the_jax_packages_bytes(tree):
    frame = wire._encode(tree)
    assert frame == jax_wire._encode(tree)
    if _has_numpy_scalar(tree):
        # the reference encodes a numpy scalar as a bare JSON number, which
        # its decoder rejects; the port keeps the same bytes (ROADMAP queue 3)
        for decode in (wire._decode, jax_wire._decode):
            with pytest.raises(ValueError, match="bad wire node"):
                decode(frame[8:])
        return
    a, b = wire._decode(frame[8:]), jax_wire._decode(frame[8:])
    # a 0-d array comes back with shape (1,) (the encoder's ascontiguousarray)
    assert repr(_plain(a)) == repr(_plain(b)) == repr(_plain(tree, np.atleast_1d))


def _has_numpy_scalar(v) -> bool:
    if isinstance(v, np.generic):
        return True
    if isinstance(v, dict):
        return any(_has_numpy_scalar(k) or _has_numpy_scalar(x) for k, x in v.items())
    if isinstance(v, (list, tuple)):
        return any(_has_numpy_scalar(x) for x in v)
    return False


def _plain(v, arr=np.asarray):
    if isinstance(v, np.ndarray):
        v = arr(v)
        return ("nd", v.dtype.str, v.shape, v.tobytes())
    if isinstance(v, dict):
        return {_plain(k, arr): _plain(x, arr) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_plain(x, arr) for x in v)
    return v


def test_addresses():
    for address in ("ipc:///tmp/x/model.ipc", "tcp://localhost:5555", "tcp://10.0.0.1:80"):
        assert wire.parse_address(address) == jax_wire.parse_address(address)
    with pytest.raises(ValueError, match="unsupported address"):
        wire.parse_address("http://localhost:1")


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    root = tmp_path_factory.mktemp("ipc")
    port = ModelServer(f"ipc://{root}/port.ipc", device="cpu").start()
    jax = JaxServer(f"ipc://{root}/jax.ipc").start()
    yield {"port": port.address, "jax": jax.address}
    port.stop()
    jax.stop()


def _raw_call(address: str, **msg) -> bytes:
    """One request on a fresh connection; the reply frame's bytes."""
    kind, target = wire.parse_address(address)
    with socket.socket(socket.AF_UNIX if kind == "unix" else socket.AF_INET) as s:
        s.connect(target)
        wire.send_msg(s, msg)
        head = wire._recv_exact(s, 8)
        return head + wire._recv_exact(s, struct.unpack("<Q", head)[0] - 8)


def _field_pixels(size=96, seed=0):
    rng = np.random.default_rng(seed)
    cells, nuclei, _ = render_cells(size, 8, rng)
    return np.stack([cells, nuclei])[None][:, :, None].astype(np.float32)  # (1, 2, 1, Y, X)


def test_threshold_group_both_ways(servers):
    pixels = _field_pixels()
    setup = {"threshold_scale": 0.4}
    want = jax_dispatch("threshold", 0, **setup)(pixels)
    assert want[0].max() >= 5
    np.testing.assert_array_equal(dispatch_segmenter("threshold", 0, device="cpu",
                                                     **setup)(pixels)[0], want[0])
    # a JAX client against the port server, a port client against the JAX server
    for make, address in ((jax_client.make_remote_segmenter, servers["port"]),
                          (client.make_remote_segmenter, servers["jax"])):
        got = make("nahual_threshold", channel_to_segment=0, address=address,
                   setup_params=setup)(pixels)
        assert len(got) == 1 and got[0].dtype == np.uint16
        np.testing.assert_array_equal(got[0], want[0])
    # the reply frames are the same bytes
    replies = []
    for address in (servers["port"], servers["jax"]):
        c = wire.Client(address)
        session = c.call("setup", model="threshold", params=setup)
        replies.append(_raw_call(address, op="process", session=session, model="threshold",
                                 data=pixels[:, 0, 0]))
        c.close()
    assert replies[0] == replies[1]


def test_embed_group_both_ways(servers):
    tiles = np.random.default_rng(1).normal(100, 20, (3, 2, 1, 32, 32)).astype(np.float32)
    setup = {"dim": 16}
    port_local = make_embedder(device="cpu", **setup)(tiles)
    jax_local = np.asarray(jax_make_embedder(**setup)(tiles))
    got = jax_client.make_remote_embedder(address=servers["port"], setup_params=setup)(tiles)
    assert got.shape == (3, 16) and got.dtype == np.float32
    np.testing.assert_array_equal(got, port_local)
    back = client.make_remote_embedder(address=servers["jax"], setup_params=setup)(tiles)
    np.testing.assert_array_equal(back, jax_local)
    assert within_model_tolerance(port_local, jax_local, "embed")


def _tracks_movie():
    masks = np.zeros((3, 2, 32, 32), np.int32)  # (T, F, Y, X)
    for t in range(3):
        masks[t, 0, 4 + t:12 + t, 4:12] = 1
        masks[t, 1, 2:10, 2 + t:10 + t] = 1
        masks[t, 1, 20:28, 20:28] = 2
    return masks


def test_trackastra_group_both_ways(servers):
    import pyarrow as pa

    masks = _tracks_movie()
    want = jax_link_tracks(masks)
    table = jax_client.make_remote_global_step("trackastra", address=servers["port"])(masks)
    assert table.equals(want)
    cols = client.make_remote_global_step("trackastra", address=servers["jax"])(masks[None])
    assert list(cols) == want.column_names
    for name in want.column_names:
        np.testing.assert_array_equal(cols[name], want.column(name).to_numpy())
    port_cols = client.make_remote_global_step("trackastra", address=servers["port"])(masks)
    assert pa.Table.from_pydict(port_cols).equals(want)
    replies = []
    for address in (servers["port"], servers["jax"]):
        c = wire.Client(address)
        session = c.call("setup", model="trackastra", params={})
        replies.append(_raw_call(address, op="process", session=session, model="trackastra",
                                 data=masks))
        c.close()
    assert replies[0] == replies[1]


def test_session_contract(servers):
    c = wire.Client(servers["port"])
    assert c.call("ping") == "pong"
    for model, impl in (("spotiflow", "aliby_tpu_torch.models.spots."),
                        ("baby", "aliby_tpu_torch.models.baby."),
                        ("threshold", "aliby_tpu_torch.models.segment."),
                        ("trackastra", "aliby_tpu_torch.net.server.")):
        params = {"base_kind": "threshold"} if model == "baby" else {}
        session = c.call("setup", model=model, params=params)
        info = c.call("describe", session=session)
        assert info["model"] == model and info["impl"].startswith(impl), info
    with pytest.raises(RuntimeError, match="unknown model group"):
        c.call("setup", model="warp_drive", params={})
    with pytest.raises(RuntimeError, match="unknown session"):
        c.call("process", session="nope", model="threshold", data=np.zeros((1, 4, 4)))
    with pytest.raises(RuntimeError, match="unknown op"):
        c.call("teleport")
    c.close()
    with pytest.raises(ValueError, match="requires an 'address'"):
        client.make_remote_embedder()


def test_baby_and_spotiflow_groups_keep_their_contracts(servers):
    from aliby_tpu_torch.test_data import render_budding_movie

    c = wire.Client(servers["port"])
    session = c.call("setup", model="baby", params={"base_kind": "threshold"})
    frames, labels, _ = render_budding_movie(128, 4, np.random.default_rng(7), n_mothers=3)
    seen = []
    for t in range(4):
        out = c.call("process", session=session, model="baby",
                     data=labels[t][None].astype(np.float32))
        assert np.asarray(out["masks"][0]).ndim == 3 and out["metadata"] is not None
        seen.append(set(out["metadata"]["cell_label"][0]))
    assert len(seen[0] & seen[-1]) >= 3  # the session carries the tracker
    session = c.call("setup", model="spotiflow", params={})
    img = np.zeros((64, 64), np.float32)
    img[20, 20] = img[40, 44] = 50.0
    mask = np.asarray(c.call("process", session=session, model="spotiflow",
                             data=img[None])["masks"][0])
    assert mask.shape == (64, 64) and len(np.unique(mask)) - 1 == 2
    c.close()


def test_nahual_pipeline_against_a_port_server(servers, tmp_path):
    """Segment (cellpose and spots), embed and track through the server; the
    same models in process give the same bits."""
    from aliby_tpu_torch.engine.core import get_step_output
    from aliby_tpu_torch.engine.global_steps import dispatch_global_step
    from aliby_tpu_torch.io import zarrlite
    from aliby_tpu_torch.io.dataset import DatasetZarr
    from aliby_tpu_torch.parallel.positions import stamp_image_kwargs
    from aliby_tpu_torch.pipe import run_pipeline_and_post
    from aliby_tpu_torch.test_data import cellpainting_movie

    ntps, size = 3, 64
    movie = cellpainting_movie(1, ntps, size, seed=3, n_cells=6)
    zarrlite.write_array(tmp_path / "store" / "pos0", movie[0], chunks=(1, 1, 1, size, size))
    position = DatasetZarr(tmp_path / "store").get_position_ids()[0]
    address = servers["port"]

    def pipeline(remote: bool) -> dict:
        seg = ({"kind": "nahual_cellpose", "address": address} if remote
               else {"kind": "cellpose"})
        spot = ({"kind": "nahual_spotiflow", "address": address, "setup_params": {}}
                if remote else {"kind": "spots"})
        embed = "nahual_embed" if remote else "embed"
        emb_params = ({"address": address, "setup_params": {"dim": 8}} if remote
                      else {"dim": 8})
        steps = {"tile": {"tile_size": None},
                 "segment_cell": {"segmenter_kwargs": seg, "channel_to_segment": 3},
                 "segment_spots": {"segmenter_kwargs": spot, "channel_to_segment": 0},
                 "extract_cell": {"tree": {"None": {"None": ["area"]}}, "kwargs": {}},
                 embed: emb_params}
        gs = ({"nahual_trackastra": {"address": address, "parameters": {}}} if remote
              else {"track_global": {"parameters": {}}})
        name = next(iter(gs))
        pipe = {"steps": steps,
                "passed_data": {"extract_cell": [("masks", "segment_cell"), ("pixels", "tile")],
                                embed: [("pixels", "tile")]},
                "passed_methods": {"segment_cell": ("tile", "get_fczyx"),
                                   "segment_spots": ("tile", "get_fczyx")},
                "save": ["segment_cell", "segment_spots", name], "save_interval": 1,
                "ntps": ntps, "global_steps": gs,
                "global_passed_data": {f"{name}_cell": ("from_disk:segment_cell",)}}
        return stamp_image_kwargs(pipe, position, capture_order="TCZYX")

    remote, _ = run_pipeline_and_post(pipeline(True), "pos0", tmp_path / "remote",
                                      device="cpu")
    local, _ = run_pipeline_and_post(pipeline(False), "pos0", tmp_path / "local", device="cpu")
    for step in ("segment_cell", "segment_spots"):
        got = get_step_output({}, [f"from_disk:{step}"], tmp_path / "remote" / "steps" / "pos0")
        want = get_step_output({}, [f"from_disk:{step}"], tmp_path / "local" / "steps" / "pos0")
        assert got.shape == (1, ntps, 1, size, size) and got.max() > 0
        np.testing.assert_array_equal(got, want)
    x_cols = [c for c in local.column_names if c.startswith("X_")]
    assert len(x_cols) == 8 and [c for c in remote.column_names if c.startswith("X_")] == x_cols
    for c in local.column_names:
        if c != "metadata_object":
            assert np.array_equal(np.asarray(remote.column(c).to_pylist(), float),
                                  np.asarray(local.column(c).to_pylist(), float),
                                  equal_nan=True), c
    import pyarrow.parquet as pq

    tracks = pq.read_table(tmp_path / "remote" / "nahual_trackastra"
                           / "pos0_nahual_trackastra_cell.parquet")
    want = pq.read_table(tmp_path / "local" / "track_global" / "pos0_track_global_cell.parquet")
    assert tracks.equals(want) and tracks.num_rows > 0
    stacked = get_step_output({}, ["from_disk:segment_cell"],
                              tmp_path / "local" / "steps" / "pos0")
    cols = dispatch_global_step("nahual_trackastra", address=address)(stacked)
    for name in TRACK_COLUMNS:
        np.testing.assert_array_equal(cols[name], want.column(name).to_numpy())


def test_link_tracks_columns_match_jax():
    masks = _tracks_movie()
    for stack in (masks, masks[:, 1]):  # (T, F, Y, X) and mono (T, Y, X)
        want = jax_link_tracks(stack)
        cols = link_tracks_columns(stack, device="cpu")
        assert tuple(cols) == TRACK_COLUMNS == tuple(want.column_names)
        for name in TRACK_COLUMNS:
            assert cols[name].dtype == (np.float64 if name.startswith("centroid") else np.int64)
            np.testing.assert_array_equal(cols[name], want.column(name).to_numpy())


def test_track_global_step_runs_without_pyarrow(monkeypatch):
    from aliby_tpu_torch.engine.global_steps import dispatch_global_step

    masks = _tracks_movie()
    want = jax_link_tracks(masks)
    for name in [m for m in sys.modules if m == "pyarrow" or m.startswith("pyarrow.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "pyarrow", None)  # any import of it raises
    with pytest.raises(ImportError):
        import pyarrow  # noqa: F401
    step = dispatch_global_step("track_global", device="cpu", parameters={})
    cols = step(masks[None])  # get_step_output's (n_fetchers, T, F, Y, X)
    for name in TRACK_COLUMNS:
        np.testing.assert_array_equal(cols[name], want.column(name).to_numpy())


def test_jax_compiled_refusal_is_kept():
    from aliby_tpu_torch.engine.compiled import try_compile

    for extra in ({"embed_x": {}}, {"nahual_embed": {"address": "ipc:///x"}}):
        pipeline = {
            "steps": {"tile": {}, "segment_cell": {"channel_to_segment": 0},
                      "extract_cell": {"tree": {}}, **extra},
            "passed_methods": {"segment_cell": ("tile", "get_fczyx")},
            "passed_data": {"extract_cell": [("masks", "segment_cell"), ("pixels", "tile")]},
        }
        assert try_compile(pipeline, device="cpu") is None
