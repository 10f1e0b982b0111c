"""The program's spans along the mesh runner, on the CPU: a TIFF plate of 3
positions (64x64, the 5 Cell Painting channels, one z) through
``run_positions_mesh`` with ``ALIBY_MESH_TIMING`` set and the builder's
default bank (every family and the colocalisation pairs), the bundled
U-Net in f32.

- The ``mesh timing`` split has ``sticky_wait`` and ``enqueue``; its keys
  are the dispatch thread's spans (``dispatch`` less the two nested in it)
  and sum to the time accounted.
- ``io.decode`` is called once a plane decoded: one per (position,
  channel, z) and one sample a position when its image is opened, as many
  as the native decoder ran.
- Each ``features.<family>`` span is called once per tree entry of that
  family per fused call (the zernike family's entries once together, as
  ``features.zernike``), and the step's spans once a call.
"""

import logging
import math
import re
from collections import Counter

import numpy as np
import pytest
import torch

from aliby_tpu_torch import native
from aliby_tpu_torch.engine import builders, compiled
from aliby_tpu_torch.io.dataset import DatasetDir
from aliby_tpu_torch.parallel import pipeline_mesh
from aliby_tpu_torch.parallel.positions import stamp_image_kwargs
from aliby_tpu_torch.test_data import CP_CHANNELS, _channel_stack, _write_tiff
from aliby_tpu_torch.utils import profiling

torch.set_num_threads(1)

SIZE, N_POS = 64, 3
REGEX = r".*__([A-Z][0-9]{2})__([0-9])__([A-Za-z]+)\.tif"
SPLIT = re.compile(r"(\w+)=([0-9.]+)s")


class Lines(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("spans")
    for p in range(N_POS):
        stack, _ = _channel_stack(SIZE, 6, seed=40 + p)
        for name, ch in CP_CHANNELS.items():
            _write_tiff(root / "plate" / f"plate1__A0{p + 1}__1__{name}.tif", stack[ch])
    positions = DatasetDir(root / "plate", regex=REGEX,
                           capture_order="WFC").get_position_ids()
    pipeline = builders.build_pipeline_steps(
        channels_to_segment={"nuclei": 0, "cell": 3}, channels_to_extract=[0, 1, 2, 3, 4],
        segmenter_extra_kwargs={"kind": "cellpose", "model_kwargs": {"dtype": torch.float32}})
    pipeline["compiled"] = True
    plans, decodes, lines = [], [], Lines()
    real_plan, real_decode = pipeline_mesh.plan_calls, native.tiff_decode

    def plan(*args, **kwargs):
        plans.append(real_plan(*args, **kwargs))
        return plans[-1]

    def decode(path, *args, **kwargs):
        out = real_decode(path, *args, **kwargs)
        decodes.append(out is not None)
        return out

    logger = logging.getLogger("aliby_tpu_torch")
    logger.addHandler(lines)
    profiling.reset()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("ALIBY_MESH_TIMING", "1")
            mp.setattr(pipeline_mesh, "plan_calls", plan)
            mp.setattr(native, "tiff_decode", decode)
            pipeline_mesh.run_positions_mesh(pipeline, positions, root / "out", regex=REGEX,
                                             capture_order="WFC", device="cpu")
        totals = profiling.totals()
    finally:
        logger.removeHandler(lines)
        profiling.reset()
    (G, C), = plans
    step = compiled.try_compile(stamp_image_kwargs(pipeline, positions[0], regex=REGEX,
                                                   capture_order="WFC"), device="cpu")
    timing = [line for line in lines.lines if line.startswith("mesh timing")]
    return {"totals": totals, "calls": math.ceil(N_POS / G) * math.ceil(1 / C),
            "decodes": decodes, "timing": timing, "step": step, "positions": positions}


def test_the_split_has_the_sticky_wait_and_the_enqueue_and_sums_to_the_time(run):
    line, = run["timing"]
    split = {k: float(v) for k, v in SPLIT.findall(line.split(": ", 1)[1])}
    assert list(split) == list(pipeline_mesh.TIMING_SPANS)
    accounted = float(re.search(r"accounted ([0-9.]+)s", line).group(1))
    assert sum(split.values()) == pytest.approx(accounted, abs=5e-3)
    t = run["totals"]
    for key, name in pipeline_mesh.TIMING_SPANS.items():
        if key != "dispatch":
            assert split[key] == pytest.approx(t[name]["host_s"], abs=1e-3), key
    assert split["dispatch"] + split["sticky_wait"] + split["enqueue"] == pytest.approx(
        t["runner.dispatch"]["host_s"], abs=2e-3)
    assert t["step.sticky_wait"]["host_s"] > 0 and t["step.enqueue"]["host_s"] > 0
    assert t["step.sticky_wait"]["n"] == t["step.enqueue"]["n"] == run["calls"]
    runner = sum(t[n]["host_s"] for n in pipeline_mesh.TIMING_SPANS.values()
                 if n.startswith("runner."))
    assert accounted == pytest.approx(runner, abs=5e-3)


def test_io_decode_counts_the_planes_read(run):
    planes = N_POS * len(CP_CHANNELS) * 1  # (position, channel, z), one timepoint
    samples = N_POS  # one read when a position's image is opened
    assert all(run["decodes"]) and len(run["decodes"]) == planes + samples
    got = run["totals"]["io.decode"]
    assert got["n"] == planes + samples
    assert got["host_s"] > 0 and got["device_s"] is None


def _family(entry) -> str:
    kind = entry[0]
    if kind in ("mask_family", "image_family"):
        return entry[1]
    return "coloc" if kind == "corr" else kind


def test_each_family_span_runs_once_per_tree_entry_per_call(run):
    groups = {}  # trees with identical plans run once over the objects' labels
    for obj_plans in run["step"].fused.plans:
        for _insts, entries, slot_of, _lookup in obj_plans:
            groups[(tuple(entries), tuple(sorted(slot_of.items(), key=lambda i: i[1])))] = entries
    want, concat = Counter(), 1  # features_phase's concatenation
    for entries in groups.values():
        families = [_family(e) for e in entries]
        zernikes = sum(f in ("zernike", "radial_zernikes") for f in families)
        if zernikes >= 2:  # one geometry and polynomial pass for all of them
            families = [f for f in families if f not in ("zernike", "radial_zernikes")]
            want["zernike"] += 1
        want.update(families)
        concat += 1 + bool(entries)  # the labels and images; the tree's stack
    want["concat"] = concat
    assert {"intensity", "sizeshape", "feret", "texture", "radial_distribution", "zernike",
            "coloc"} <= set(want)
    got = {name.split(".", 1)[1]: t["n"] for name, t in run["totals"].items()
           if name.startswith("features.")}
    assert got == {f: n * run["calls"] for f, n in want.items()}
    assert all(t["device_s"] is None for t in run["totals"].values())  # no card here


def test_the_segmentation_spans_run_once_a_segmentation(run):
    t = run["totals"]
    n = {s: t[f"seg.{s}"]["n"] for s in ("normalize", "network", "dynamics", "qc")}
    assert len(set(n.values())) == 1 and n["network"] >= run["calls"]
    assert np.all([t[f"seg.{s}"]["host_s"] > 0 for s in n])
