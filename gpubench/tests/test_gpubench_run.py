"""The harness's plumbing on the CPU at small sizes: a dry run of a cell
loads neither JAX nor the JAX package, the reference loads nothing of the
program, and the output check refuses the control (the reference in the
nearest lower precision in the program's place) and a timed path broken
underneath, each by the cell's own limits."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

# pyarrow's default allocator has crashed the program's parquet writers on
# some CPU hosts after the harness's forks; the system allocator has not
os.environ.setdefault("ARROW_DEFAULT_MEMORY_POOL", "system")
ROOT = Path(__file__).resolve().parents[2]
SMALL = ["--size", "256", "--cells", "30", "--fields", "1", "--seconds", "0"]
FORBIDDEN = {"jax", "jaxlib", "flax", "aliby_tpu"}


def _subprocess(code: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2",
               ARROW_DEFAULT_MEMORY_POOL="system")
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_dry_run_loads_no_jax_and_no_jax_package():
    got = _subprocess(f"""
import json, sys, time
t0 = time.perf_counter()
from gpubench import bench
args = bench.parse(["--workload", "cellposenet.plate-ex01", "--seed", "4000000007",
                    "--trace", "0", *{SMALL!r}])
line = bench.run_cell(args, ["cpu"], t0, workers=2)
mods = {{m.split(".")[0] for m in sys.modules}}
print(json.dumps({{"line": line is not None, "forbidden": sorted(mods & set({sorted(FORBIDDEN)!r})),
                  "port": "aliby_tpu_torch" in mods}}))
""")
    assert got == {"line": True, "forbidden": [], "port": True}


def test_the_reference_loads_nothing_of_the_program():
    got = _subprocess("""
import json, sys
import gpubench.reference.unet, gpubench.reference.dynamics, gpubench.reference.features
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules}
                        & {"aliby_tpu_torch", "aliby_tpu", "jax", "jaxlib", "flax"})))
""")
    assert got == []


# --- the check refuses the control and a broken timed path ------------------


def _run(workload: str, seed: int, patches=(), control=False) -> dict:
    """One dry run of ``workload`` with ``patches`` ((object, name, factory)
    applied to the program for the run); the result line, or the control's
    numbers judged against the cell's limits."""
    from gpubench import bench, check

    torch.set_num_threads(2)
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    for obj, name, factory in patches:
        setattr(obj, name, factory(getattr(obj, name)))
    judged = {}
    if control:
        judge = check.judge

        def both(run, outputs, seed, device, control=False):
            judged.update(judge(run, outputs, seed, device, control=True))
            return judge(run, outputs, seed, device)

        check.judge = both
        saved.append((check, "judge", judge))
    try:
        args = bench.parse(["--workload", workload, "--seed", str(seed), "--trace", "0", *SMALL])
        line = bench.run_cell(args, ["cpu"], time.perf_counter(), workers=2)
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
    if control:
        limits = bench.load_cell(workload)["limits"]["limits"]
        return {k: {"value": v, "limit": limits[k]} for k, v in judged.items()}
    return line["check"]


def failed(numbers: dict) -> list:
    return [k for k, v in numbers.items() if not v["value"] <= v["limit"]]


CELLS = ("cellposenet.plate-fullbank", "cellposenet.plate-ex01")


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_refused(workload):
    assert failed(_run(workload, 4000000011, control=True))


def _two_rounds(max_fields):
    """Each call holds half the plate's fields (one), as a card's memory
    makes each call hold half of a card's two wells."""
    def half(self, field_pixels):
        return 1
    return half


def _stale(dispatch):
    """The fused step returns its first call's results for every later call."""
    first = []

    def stale(self, blocks, shards=None):
        out = dispatch(self, blocks, shards=shards)
        if not first:
            first.append(out)
        return first[0]
    return stale


def _half_left_out(segment_all):
    """The second half of each object's fields get no labels."""
    def half(self, images):
        labels = segment_all(self, images)
        P = labels.shape[0] // 2
        labels[P // 2:P] = 0
        labels[P + P // 2:] = 0
        return labels
    return half


def _altered(tree_collect):
    """One feature of every object is altered where it is produced."""
    def altered(*args, **kwargs):
        names, arr = tree_collect(*args, **kwargs)
        arr = arr.clone()
        arr[0] *= 1.05
        return names, arr
    return altered


def test_a_broken_timed_path_is_refused():
    from aliby_tpu_torch.engine import compiled, fused
    from aliby_tpu_torch.models import segment

    rounds = (compiled.CompiledStep, "max_fields", _two_rounds)
    faults = {
        "state unchanged": [rounds, (fused.ShardedStep, "dispatch", _stale)],
        "half the batch left out": [(segment.CellposeTorch, "_segment_all", _half_left_out)],
        "an answer altered": [(fused, "tree_collect", _altered)],
    }
    for what, patches in faults.items():
        assert failed(_run("cellposenet.plate-ex01", 4000000013, patches)), what
    assert not failed(_run("cellposenet.plate-ex01", 4000000013, [rounds])), "sound"


def _upper_half(value):
    """One feature of the objects whose label lies above their field's
    median label (``Intensity_MeanIntensity`` where the tree has it) set to
    ``value(old)`` where it is produced; the other objects and columns are
    left as they are."""
    def wrap(tree_collect):
        def altered(plan_sig, labels, imgs, max_labels):
            names, arr = tree_collect(plan_sig, labels, imgs, max_labels)
            arr = arr.clone()
            j = next((i for i, n in enumerate(names) if n.endswith("::Intensity_MeanIntensity")), 0)
            for f in range(labels.shape[0]):
                n = int(labels[f].max())  # column l holds label l + 1
                arr[j, f, n // 2:n] = value(arr[j, f, n // 2:n])
            return names, arr
        return altered
    return wrap


@pytest.mark.parametrize("what,value", [("altered by 1%", lambda v: v * 1.01),
                                        ("missing", lambda v: torch.full_like(v, float("nan")))])
def test_a_fault_in_half_the_objects_of_one_column_is_refused(what, value):
    from aliby_tpu_torch.engine import fused

    got = _run("cellposenet.plate-ex01", 4000000019, [(fused, "tree_collect", _upper_half(value))])
    assert [k for k in failed(got) if k.startswith("feat.")], (what, got)
