"""The port's tracking (``aliby_tpu_torch.track``, ``ops.labels``) against
the JAX package on the CPU, bit for bit.

- ``relabel_sequential``: background present or absent, more distinct
  labels than ``max_labels`` (the reference keeps the smallest
  ``max_labels + 1`` and clips later ranks), global labels far above
  ``max_labels``, values <= 0, hypothesis-drawn maps; the batched form is
  the per-image form.
- ``stitch_pair``: random maps and thresholds, IoU ties (the first previous
  object wins, as ``jnp.argmax``), an unmatched object above the carried
  maximum, hypothesis-drawn maps.
- The scenarios of ``tests/test_track.py``: identity over a sequence, the
  per-tp state protocol, no resurrection after a disappearance, the
  ``link_tracks`` table (equal to the JAX package's).
- ``stitch_movie`` over two chunks with the carried state equals the
  ``stitch_rois`` chain (``tests/test_movie_mode.py``'s shape), and JAX's
  ``stitch_movie`` with and without carried state.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from aliby_tpu.ops.labels import relabel_sequential as jax_relabel
from aliby_tpu.track.dispatch import dispatch_tracker as jax_dispatch_tracker
from aliby_tpu.track.linker import link_tracks as jax_link_tracks
from aliby_tpu.track.trackers import stitch_movie as jax_stitch_movie
from aliby_tpu.track.trackers import stitch_pair as jax_stitch_pair
from aliby_tpu.track.trackers import stitch_sequence as jax_stitch_sequence
from aliby_tpu_torch.ops.labels import (
    num_labels,
    relabel_sequential,
    relabel_sequential_batched,
    to_uint16_labels,
)
from aliby_tpu_torch.track import dispatch_tracker
from aliby_tpu_torch.track.linker import link_tracks
from aliby_tpu_torch.track.trackers import stitch_movie, stitch_pair, stitch_rois, stitch_sequence

torch.set_num_threads(1)


def _relabel_both(lab: np.ndarray, max_labels: int):
    want, w_fwd = jax_relabel(jnp.asarray(lab), max_labels)
    got, g_fwd = relabel_sequential(torch.from_numpy(lab), max_labels)
    return (np.asarray(want), np.asarray(w_fwd)), (got.numpy(), g_fwd.numpy())


def _edge_map(case: str, rng) -> tuple[np.ndarray, int]:
    if case == "background":
        return rng.integers(0, 9, (24, 24)).astype(np.int32), 16
    if case == "no_background":
        return rng.integers(1, 9, (24, 24)).astype(np.int32), 16
    if case == "more_than_max_labels":
        return rng.integers(0, 60, (24, 24)).astype(np.int32), 12
    if case == "more_than_max_labels_no_background":
        return rng.integers(1, 60, (24, 24)).astype(np.int32), 12
    if case == "large_globals":
        return (rng.integers(0, 6, (24, 24)) * 7919 + 100_000).astype(np.int32) * \
            (rng.random((24, 24)) < 0.7), 8
    if case == "non_positive":
        return rng.integers(-4, 9, (24, 24)).astype(np.int32), 16
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["background", "no_background", "more_than_max_labels",
                                  "more_than_max_labels_no_background", "large_globals",
                                  "non_positive"])
def test_relabel_sequential_matches_jax(case):
    lab, max_labels = _edge_map(case, np.random.default_rng(len(case)))
    (want, w_fwd), (got, g_fwd) = _relabel_both(lab.astype(np.int32), max_labels)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(g_fwd, w_fwd)
    assert got.dtype == np.int32 and g_fwd.dtype == lab.dtype


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(1, 20), st.integers(1, 70), st.integers(-3, 1))
def test_relabel_sequential_hypothesis(seed, max_labels, n_values, low):
    rng = np.random.default_rng(seed)
    lab = rng.integers(low, n_values + 1, (9, 11)).astype(np.int32)
    (want, w_fwd), (got, g_fwd) = _relabel_both(lab, max_labels)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(g_fwd, w_fwd)


def test_relabel_sequential_batched_is_per_image():
    rng = np.random.default_rng(3)
    labs = np.stack([rng.integers(0, 30, (16, 16)), rng.integers(1, 5, (16, 16)),
                     np.zeros((16, 16), int)]).astype(np.int32)
    got, fwd = relabel_sequential_batched(torch.from_numpy(labs), 10)
    for b in range(3):
        want, w_fwd = jax_relabel(jnp.asarray(labs[b]), 10)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))
        np.testing.assert_array_equal(fwd[b].numpy(), np.asarray(w_fwd))


def test_num_labels_and_uint16():
    lab = torch.tensor([[0, 3], [7, 1]], dtype=torch.int32)
    assert int(num_labels(lab)) == 7
    out = to_uint16_labels(lab)
    assert out.dtype == np.uint16 and out.tolist() == [[0, 3], [7, 1]]
    with pytest.raises(ValueError, match="overflow"):
        to_uint16_labels(np.array([70000]))


def _pair_both(prev, cur, max_label, max_labels, thr):
    want_g, want_m = jax_stitch_pair(jnp.asarray(prev), jnp.asarray(cur), jnp.int32(max_label),
                                     max_labels=max_labels, iou_threshold=thr)
    got_g, got_m = stitch_pair(torch.from_numpy(prev)[None], torch.from_numpy(cur)[None],
                               torch.tensor([max_label]), max_labels=max_labels,
                               iou_threshold=thr)
    np.testing.assert_array_equal(got_g[0].numpy(), np.asarray(want_g))
    assert int(got_m[0]) == int(want_m)
    assert got_g.dtype == torch.int32 and got_m.dtype == torch.int32
    return got_g[0].numpy()


@pytest.mark.parametrize("thr", [0.0, 0.01, 0.1, 0.25, 0.5])
def test_stitch_pair_matches_jax(thr):
    rng = np.random.default_rng(int(thr * 100))
    for _ in range(6):
        max_labels = int(rng.integers(3, 20))
        prev = (rng.integers(0, 9, (20, 20)) * rng.choice([1, 31])).astype(np.int32)
        cur = rng.integers(0, min(max_labels + 1, 12), (20, 20)).astype(np.int32)
        _pair_both(prev, cur, int(prev.max()) + int(rng.integers(0, 4)), max_labels, thr)


def test_stitch_pair_iou_ties_take_the_first_previous_object():
    prev = np.zeros((8, 8), np.int32)
    prev[:, :4] = 40  # two previous objects, each half of the current one
    prev[:, 4:] = 17
    cur = np.ones((8, 8), np.int32)
    out = _pair_both(prev, cur, 40, 8, 0.25)
    assert (out == 17).all()  # compact id 1 (global 17) comes first
    # an unmatched object takes the next label above the carried maximum
    cur2 = np.zeros((8, 8), np.int32)
    cur2[0, 0] = 1
    out2 = _pair_both(prev, cur2, 90, 8, 0.25)
    assert out2[0, 0] == 91


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(1, 12), st.sampled_from([0.0, 0.01, 0.25, 0.6]))
def test_stitch_pair_hypothesis(seed, max_labels, thr):
    rng = np.random.default_rng(seed)
    prev = (rng.integers(0, 8, (10, 10)) * int(rng.integers(1, 1000))).astype(np.int32)
    cur = rng.integers(0, max_labels + 3, (10, 10)).astype(np.int32)
    _pair_both(prev, cur, int(prev.max()), max_labels, thr)


def _moving_blobs(T=4, size=64, drift=(2, 1)):
    """Two blobs translating per frame + one appearing at tp2 (``tests/test_track.py``)."""
    seq = []
    for t in range(T):
        m = np.zeros((size, size), np.int32)
        dy, dx = drift[0] * t, drift[1] * t
        m[8 + dy: 18 + dy, 8 + dx: 18 + dx] = 1
        m[36 + dy: 48 + dy, 30 + dx: 42 + dx] = 2
        if t >= 2:
            m[50:58, 8:16] = 3
        seq.append(m)
    return np.stack(seq)


def test_stitch_sequence_tracks_identity():
    seq = _moving_blobs()
    out = stitch_sequence(torch.from_numpy(seq)).numpy()
    np.testing.assert_array_equal(out, np.asarray(jax_stitch_sequence(jnp.asarray(seq))))
    for t in range(4):
        assert out[t, 10 + 2 * t, 10 + t] == out[0, 10, 10]
        assert out[t, 40 + 2 * t, 34 + t] == out[0, 40, 34]
    new_id = out[2, 54, 12]
    assert new_id not in (out[0, 10, 10], out[0, 40, 34]) and out[3, 54, 12] == new_id


def test_stitch_rois_state_protocol():
    seq = _moving_blobs()
    tracker, jax_tracker = dispatch_tracker("stitch", device="cpu"), jax_dispatch_tracker("stitch")
    state = jstate = None
    for t in range(4):
        masks = [[seq[t]]] if t == 0 else [[seq[t - 1], seq[t]]]
        state = tracker(masks, state=state)
        jstate = jax_tracker(masks, state=jstate)
        assert state["max_label"] == jstate["max_label"]
        assert all(isinstance(m, int) for m in state["max_label"])
        np.testing.assert_array_equal(state["labels"][0], np.asarray(jstate["labels"][0]))
    assert set(state) == {"labels", "max_label"} and state["max_label"][0] == 3
    assert state["labels"][0][54, 12] == 3


def test_relabel_after_disappearance():
    a = np.zeros((32, 32), np.int32)
    a[4:12, 4:12] = 1
    a[20:28, 20:28] = 2
    b = np.zeros((32, 32), np.int32)
    b[4:12, 4:12] = 1  # object 2 gone
    c = np.zeros((32, 32), np.int32)
    c[4:12, 4:12] = 1
    c[18:26, 18:26] = 2  # close to the old 2, no overlap with tp-1
    seq = np.stack([a, b, c])
    out = stitch_sequence(torch.from_numpy(seq)).numpy()
    np.testing.assert_array_equal(out, np.asarray(jax_stitch_sequence(jnp.asarray(seq))))
    assert out[2, 22, 22] == 3  # a fresh id, not a resurrected 2


def test_link_tracks_table():
    seq = _moving_blobs()
    table = link_tracks(seq, device="cpu")
    assert table.equals(jax_link_tracks(seq))
    tids = {}
    for row in table.to_pylist():
        tids.setdefault(row["track_id"], []).append(row["timepoint"])
    assert sorted(len(v) for v in tids.values()) == [2, 4, 4]
    # several tiles: ids offset per tile, as the reference
    multi = np.stack([seq, seq[:, ::-1]], axis=1)  # (T, F, Y, X)
    assert link_tracks(multi, device="cpu").equals(jax_link_tracks(multi))


def _discs(T=6, F=2, H=64, W=64):
    """``tests/test_movie_mode.py``'s drifting discs that appear and vanish."""
    movies = np.zeros((T, F, H, W), np.int32)
    yy, xx = np.mgrid[0:H, 0:W]
    for f in range(F):
        for t in range(T):
            for i in range(3 + (t + f) % 2):
                disc = (yy - (10 + 8 * i + t)) ** 2 + (xx - (12 + 14 * i + f * 3)) ** 2 <= 16
                movies[t, f][disc & (movies[t, f] == 0)] = i + 1
    return movies


def test_stitch_movie_matches_sequential_rois():
    movies = _discs()
    T, F = movies.shape[:2]
    state, seq_states = None, []
    for t in range(T):
        tile_major = [[movies[t - 1, f], movies[t, f]] if t else [movies[t, f]] for f in range(F)]
        state = stitch_rois(tile_major, state=state, device="cpu")
        seq_states.append(state)
    zeros = torch.zeros((F,) + movies.shape[2:], dtype=torch.int32)
    g1, m1 = stitch_movie(torch.from_numpy(movies[:4]), zeros, torch.zeros(F, dtype=torch.int32),
                          False)
    g2, m2 = stitch_movie(torch.from_numpy(movies[4:]), g1[-1], m1[-1], True)
    g, m = torch.cat([g1, g2]).numpy(), torch.cat([m1, m2]).numpy()
    for t in range(T):
        assert m[t].tolist() == seq_states[t]["max_label"]
        for f in range(F):
            np.testing.assert_array_equal(g[t, f], seq_states[t]["labels"][f])
    # JAX's scan over the same chunks, and a per-tile has_init
    jg1, jm1 = jax_stitch_movie(jnp.asarray(movies[:4]), jnp.asarray(zeros.numpy()),
                                jnp.zeros(F, jnp.int32), jnp.asarray(False))
    np.testing.assert_array_equal(g1.numpy(), np.asarray(jg1))
    np.testing.assert_array_equal(m1.numpy(), np.asarray(jm1))
    mixed, mm = stitch_movie(torch.from_numpy(movies[4:]), g1[-1], m1[-1],
                             torch.tensor([True, False]))
    np.testing.assert_array_equal(mixed[:, 0].numpy(), g2[:, 0].numpy())
    fresh, _ = stitch_movie(torch.from_numpy(movies[4:, 1:]), g1[-1, 1:], m1[-1, 1:], False)
    np.testing.assert_array_equal(mixed[:, 1].numpy(), fresh[:, 0].numpy())
