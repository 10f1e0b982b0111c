"""Port parity: ``aliby_tpu_torch.io.h5compat`` against ``aliby_tpu.io.h5compat``
(the scenarios of ``tests/test_h5compat.py``): both packages write files
with the same datasets, values and attributes, and each reads the other's."""

import h5py
import numpy as np
import pytest

from aliby_tpu.io import h5compat as J
from aliby_tpu.tile.geometry import TileLocations as JTileLocations
from aliby_tpu_torch.io import h5compat as P
from aliby_tpu_torch.tile.geometry import TileLocations


def _contents(path) -> dict:
    out = {}
    with h5py.File(path, "r") as h5:
        def visit(name, obj):
            attrs = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                     for k, v in obj.attrs.items()}
            if isinstance(obj, h5py.Dataset):
                out[name] = (obj[()].tolist(), str(obj.dtype), obj.maxshape,
                             obj.compression, attrs)
            else:
                out[name] = attrs
        h5.visititems(visit)
    return out


def _write_dynamic(mod, path):
    w = mod.DynamicWriter(path, group="cells")
    results = [w.append("area", np.asarray([1.0, 2.0]), tp=0),
               w.append("area", np.asarray([1.5, 2.5]), tp=1),
               w.append("area", np.asarray([9.0, 9.0]), tp=0),  # already there: skipped
               w.append("ids", np.asarray([3, 4], np.int32), tp=0)]
    return results, w.written_tps("area"), w.written_tps("missing")


def test_dynamic_writer_matches_jax(tmp_path):
    got = _write_dynamic(P, tmp_path / "port.h5")
    want = _write_dynamic(J, tmp_path / "jax.h5")
    assert got == want == ([True, True, False, True], 2, 0)
    assert _contents(tmp_path / "port.h5") == _contents(tmp_path / "jax.h5")


@pytest.mark.parametrize("tile_size", [32, None])
def test_tiler_writer_matches_jax(tmp_path, tile_size):
    for mod, locs_cls, name in ((P, TileLocations, "port.h5"), (J, JTileLocations, "jax.h5")):
        locs = locs_cls.from_tiler_init(np.asarray([[50.0, 60.0], [10.0, 12.5]]), tile_size)
        w = mod.TilerH5Writer(tmp_path / name)
        w.write(locs, tp=0)
        locs.add_drift([1.0, -2.0])
        w.write(locs, tp=1)
        w.write(locs, tp=1)  # the same tp again: skipped
    got = _contents(tmp_path / "port.h5")
    assert got == _contents(tmp_path / "jax.h5")
    assert got["trap_info/drifts"][0] == [[0.0, 0.0], [1.0, -2.0]]


def test_state_round_trip_matches_jax(tmp_path):
    state = {"labels": [np.arange(12).reshape(3, 4), None, np.ones((2, 2), np.uint16)],
             "max_label": [11, 0, 1]}
    P.StateH5Writer(tmp_path / "port.h5").write(state, tp=5)
    J.StateH5Writer(tmp_path / "jax.h5").write(state, tp=5)
    P.StateH5Writer(tmp_path / "port.h5").write({"labels": [np.zeros((2, 2))], "max_label": [0]},
                                                tp=6)
    J.StateH5Writer(tmp_path / "jax.h5").write({"labels": [np.zeros((2, 2))], "max_label": [0]},
                                               tp=6)
    assert _contents(tmp_path / "port.h5") == _contents(tmp_path / "jax.h5")
    for a, b in ((P, J), (J, P)):  # each package reads the other's file
        got = a.read_state(tmp_path / "jax.h5" if a is P else tmp_path / "port.h5")
        want = b.read_state(tmp_path / "port.h5" if b is P else tmp_path / "jax.h5")
        assert got["timepoint"] == want["timepoint"] == 6
        assert got["max_label"] == want["max_label"] == [0]
        for x, y in zip(got["labels"], want["labels"]):
            np.testing.assert_array_equal(x, y)
    assert P.read_state(tmp_path / "nothing.h5") is None
    with h5py.File(tmp_path / "empty.h5", "w"):
        pass
    assert P.read_state(tmp_path / "empty.h5") is None
