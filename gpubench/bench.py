"""One run of one cell of the benchmark.

    python gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration (``gpubench/configs/<name>.json``: the network, its weights
and precision, the field and the segmenter) and a traffic mix
(``gpubench/traffic/<name>.json``: the plate's layout and the feature
bank). Set-up renders the plate from the seed, writes it as TIFFs under
``TMPDIR``, builds the pipeline as a user's script does
(``engine.builders.build_pipeline_steps``, compiled), finds the positions
with ``io.dataset.DatasetDir`` and runs one round of the cell's own call
shapes. The window then runs whole passes of the plate through
``parallel.pipeline_mesh.run_positions_mesh`` over the cell's cards, each
into a fresh output directory, until ``--seconds`` have passed; the pass in
flight is finished. With ``--trace 1`` one more pass runs under the
profiler after the window, and the per-layer metrics are read
(``gpubench/metrics/<name>.py``). Then the output check runs
(``gpubench/check.py``) and the result line is printed.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import logging
import os
import re
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "aliby_tpu")
TIMING = re.compile(r"(\w+)=([0-9.]+)s")
CONTROL_SEEDS = 3  # the readings' seeds that the control is read on too


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def load_cell(name: str) -> dict:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    limits_file = HERE / "limits" / f"{name}.json"
    limits = json.loads(limits_file.read_text()) if limits_file.exists() else {}
    metrics = {m["name"]: m for m in bench["end_to_end"] + bench["per_layer"]
               if name in m.get("workloads", [name])}
    return {"bench": bench, "cell": cell, "config": config, "traffic": traffic,
            "limits": limits, "metrics": metrics}


def reader(metric: str):
    """``gpubench/metrics/<metric>.py``'s ``read``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"gpubench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class TimingLog(logging.Handler):
    """Sums the runner's ``ALIBY_MESH_TIMING`` split over the passes."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.total: dict[str, float] = {}

    def emit(self, record):
        if str(record.msg).startswith("mesh timing"):
            for k, v in TIMING.findall(str(record.args[2])):
                self.total[k] = self.total.get(k, 0.0) + float(v)


def build_pipeline(config: dict, traffic: dict, weights: str | None) -> dict:
    from aliby_tpu_torch.engine.builders import build_pipeline_steps
    from gpubench.plate import channel_index

    seg_kwargs = dict(config["segmenter"]["kwargs"])
    if weights is not None:
        seg_kwargs["pretrained_path"] = weights
    pipeline = build_pipeline_steps(
        channels_to_segment={obj: channel_index(stain)
                             for obj, stain in config["segment"].items()},
        channels_to_extract=[channel_index(s) for s in config["field"]["stains"]],
        features_to_extract=tuple(traffic["features"]),
        cp_measure_feature_kwargs=traffic.get("cp_measure_feature_kwargs"),
        segmenter_extra_kwargs=seg_kwargs)
    pipeline.update(compiled=True, ntps=traffic["tps"])
    return pipeline


class Run:
    """The state of one run: the plate, the pipeline, the cards."""

    def __init__(self, spec: dict, seed: int, tmp: Path, devices: list, workers: int | None):
        from gpubench import check, plate

        self.seed, self.tmp = seed, tmp
        config, traffic = spec["config"], spec["traffic"]
        self.config, self.traffic, self.limits = config, traffic, spec["limits"]
        self.devices = devices
        field = config["field"]
        wells = config["wells_per_card"] * len(devices)
        self.wells = wells
        self.stacks = plate.make_plate(tmp / "plate", seed, wells, traffic["fields_per_well"],
                                       field["size"], field, workers)
        order = plate.plate_order(seed, len(self.stacks))
        self.field_index = {k: int(order[i]) for i, k in enumerate(self.stacks)}
        self.by_index = [None] * len(self.stacks)
        for k, i in self.field_index.items():
            self.by_index[i] = self.stacks[k]
        # forked before the card is touched: the workers hold the pixels
        self.oracle = check.FeatureOracle(
            dict(enumerate(self.by_index)), workers or min(8 * len(devices), os.cpu_count() or 1))
        self.objects = list(config["segment"])
        self.plate_dir = tmp / "plate"

    def find_positions(self):
        from aliby_tpu_torch.io.dataset import DatasetDir
        from gpubench import plate

        self.positions = DatasetDir(self.plate_dir, regex=plate.REGEX,
                                    capture_order=plate.CAPTURE_ORDER).get_position_ids()
        self.keys = [p["key"] for p in self.positions]
        if sorted(self.keys) != sorted(self.stacks):
            raise RuntimeError(f"positions found {self.keys[:3]}... != the plate's")

    def use_seed(self, seed: int):
        """The plate of another seed (the same fields in its order), written
        from the fields already rendered."""
        from gpubench import plate

        shutil.rmtree(self.plate_dir, ignore_errors=True)
        self.seed, self.plate_dir = seed, self.tmp / f"plate-{seed}"
        self.stacks = plate.rewrite_plate(self.plate_dir, seed, self.wells,
                                          self.traffic["fields_per_well"], self.by_index)
        order = plate.plate_order(seed, len(self.stacks))
        self.field_index = {k: int(order[i]) for i, k in enumerate(self.stacks)}
        self.find_positions()

    def prepare(self):
        """Weights, pipeline, positions, mesh; after the plate."""
        import torch

        from aliby_tpu_torch.parallel.mesh import make_mesh

        self.cpnet_state = None
        weights = None
        net = self.config["network"]
        if net["kind"] == "cpnet":
            from gpubench.weights import cpnet_state_dict

            self.cpnet_state = cpnet_state_dict(net["weights_seed"], net["nbase"],
                                                self.devices[0], self.config["field"])
            weights = str(self.tmp / "cpnet_cyto_torch.pt")
            torch.save(self.cpnet_state, weights)
        self.pipeline = build_pipeline(self.config, self.traffic, weights)
        self.find_positions()
        self.mesh = make_mesh(devices=self.devices)
        # the kernels and the TIFF decoder from the checkout's build cache
        # (built there on the first run), here on one thread: the shards'
        # threads would otherwise build them at once
        from aliby_tpu_torch import native

        native.available()
        if any(str(d).startswith("cuda") for d in self.devices):
            from aliby_tpu_torch.kernels import _build

            for name in _build.PROTOTYPES:
                _build.load(name)

    def run_pass(self, out_dir: Path, positions=None) -> float:
        import torch

        from aliby_tpu_torch.parallel.pipeline_mesh import run_positions_mesh
        from gpubench import plate

        t0 = time.perf_counter()
        run_positions_mesh(self.pipeline, positions or self.positions, out_dir,
                           regex=plate.REGEX, capture_order=plate.CAPTURE_ORDER,
                           mesh=self.mesh, overwrite=True)
        for d in self.devices:
            torch.cuda.synchronize(d) if str(d).startswith("cuda") else None
        return time.perf_counter() - t0


def device_info(devices: list) -> dict:
    import torch

    cards = [d for d in devices if str(d).startswith("cuda")]
    if not cards:
        return {"platform": "cpu", "kind": "cpu", "count": len(devices), "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(cards[0]), "count": len(cards),
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d) for d in cards)}


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def set_up(spec: dict, args, devices: list, tmp: Path, t_start: float, workers) -> Run:
    """The plate, the pipeline and one warm round of the cell's own call
    shapes."""
    if args.size:  # a dry run's small fields
        spec["config"]["field"].update(size=args.size, cells=args.cells)
    if args.fields:
        spec["traffic"]["fields_per_well"] = args.fields
    run = Run(spec, args.seed, tmp, devices, workers)
    log(f"[setup] plate rendered and written at {time.perf_counter() - t_start:.2f} s")
    run.prepare()
    log(f"[setup] pipeline prepared at {time.perf_counter() - t_start:.2f} s")
    warm = run.positions[:spec["traffic"]["fields_per_well"] * len(devices)]
    run.run_pass(tmp / "warm", warm)
    shutil.rmtree(tmp / "warm", ignore_errors=True)
    log(f"[setup] warm round done at {time.perf_counter() - t_start:.2f} s")
    return run


def read_limits(run: Run, spec: dict, args, devices: list, tmp: Path) -> None:
    """The readings that the limits are set from, in one process: for each
    seed of ``--readings`` (comma separated; the first is ``--seed``) that
    seed's plate, one pass and the check, and the control's numbers on the
    first ``CONTROL_SEEDS``; one ``[readings]`` line a seed on standard
    error, with the worst feature pair, and with ``--dump <dir>`` every
    feature pair compared (``<cell>-<seed>-<program|control>.npz``)."""
    from gpubench import check

    seeds = [int(v) for v in args.readings.split(",")]
    size = spec["config"]["field"]["size"]
    strata = spec["traffic"]["check_strata"] * len(devices)
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        if seed != run.seed:
            run.use_seed(seed)
        sampled = check.sample_positions(run.keys, seed, strata)
        capture = check.Capture(run.keys, sampled, devices, len(run.objects), (size, size))
        out_dir = tmp / f"pass-{seed}"
        with capture:
            capture.new_pass()
            dt = run.run_pass(out_dir)
        outputs = check.collect_outputs(run, capture, sampled, out_dir)
        got = {"seed": seed, "pass_s": dt}
        for side in ("program", "control")[:1 + (i < CONTROL_SEEDS)]:
            details: dict = {}
            got[side] = check.judge(run, outputs, seed, devices[0], control=side == "control",
                                    details=details)
            columns, err, one = check.pair_errors(details["pairs"])
            if args.dump:
                Path(args.dump).mkdir(parents=True, exist_ok=True)
                np.savez_compressed(
                    Path(args.dump) / f"{args.workload}-{seed}-{side}.npz", columns=columns,
                    objects=details["objects"], err=err.astype(np.float32), one_sided=one,
                    program=np.array([details["pairs"][c][0] for c in columns]).T,
                    oracle=np.array([details["pairs"][c][1] for c in columns]).T)
            i_obj, j_col = np.unravel_index(int(np.argmax(err)), err.shape) if err.size else (0, 0)
            if err.size:
                got[f"{side}_worst"] = [columns[j_col], details["objects"][i_obj],
                                        float(err[i_obj, j_col])]
        got["seconds"] = time.perf_counter() - t0
        log("[readings] " + json.dumps(got))
        del capture, outputs
        shutil.rmtree(out_dir, ignore_errors=True)


def run_cell(args, devices: list, t_start: float, workers: int | None = None) -> dict | None:
    """Set-up, window, traced pass, output check; returns the result line
    (without printing it). ``devices`` are the cards (or ``["cpu"]`` for a
    dry run of the plumbing)."""
    import torch

    from gpubench import check, trace

    spec = load_cell(args.workload)
    base = Path(os.environ.get("TMPDIR") or tempfile.gettempdir())
    tmp = Path(tempfile.mkdtemp(prefix=f"gpubench-{args.workload}-", dir=base))
    run = None
    try:
        run = set_up(spec, args, devices, tmp, t_start, workers)
        if args.readings:
            read_limits(run, spec, args, devices, tmp)
            return None
        cards = [d for d in devices if str(d).startswith("cuda")]
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
        sampled = check.sample_positions(run.keys, args.seed, spec["traffic"]["check_strata"]
                                         * len(devices))
        size = spec["config"]["field"]["size"]
        capture = check.Capture(run.keys, sampled, devices, len(run.objects), (size, size))
        timing = TimingLog()
        logger = logging.getLogger("aliby_tpu_torch")
        logger.addHandler(timing)
        if args.trace:
            os.environ["ALIBY_MESH_TIMING"] = "1"
        setup_s = time.perf_counter() - t_start
        passes, elapsed = [], 0.0
        with capture:
            while True:
                capture.new_pass()
                dt = run.run_pass(tmp / f"pass{len(passes)}")
                passes.append(dt)
                elapsed += dt
                if elapsed >= args.seconds:
                    break
            os.environ.pop("ALIBY_MESH_TIMING", None)
            logger.removeHandler(timing)
            last = tmp / f"pass{len(passes) - 1}"
            n_fields = len(run.keys)
            ctx = {"setup_s": setup_s, "window_s": elapsed, "window_fields": n_fields * len(passes),
                   "passes": passes, "timing": timing.total, "config": spec["config"],
                   "devices": devices, "trace": None}
            result_device = device_info(devices)
            if args.trace:
                from torch.profiler import record_function

                ranges = trace.Ranges()
                capture.new_pass()
                with ranges, trace.traced_pass() as prof:
                    with record_function(trace.PASS):
                        run.run_pass(tmp / "traced")
                last = tmp / "traced"
                t0 = time.perf_counter()
                ctx["trace"] = trace.reduce_events(prof)
                ctx["ranges"] = ranges
                ctx["traced_fields"] = n_fields
                log(f"[trace] reduced in {time.perf_counter() - t0:.1f} s: "
                    f"{ctx['trace']['kernels']} kernels, ops by range "
                    f"{ctx['trace']['range_ops']}, launches not found "
                    f"{ctx['trace']['unattributed_launches']}")
                del prof
        if cards:
            for d in cards:
                torch.cuda.synchronize(d)
        metrics = {}
        for name, m in spec["metrics"].items():
            want_trace = m in spec["bench"]["per_layer"]
            if bool(args.trace) != want_trace:
                continue
            value = reader(name)(ctx)
            if value is not None:
                metrics[name] = {"value": value, "unit": m["unit"]}
        if args.trace and ctx["trace"]:
            result_device.update(
                busy_s=float(np.mean([ctx["trace"]["busy_s"].get(i, 0.0)
                                      for i in range(max(1, len(cards)))])),
                window_s=ctx["trace"]["window_s"])
        outputs = check.collect_outputs(run, capture, sampled, last)
        ctx.pop("ranges", None)
        gone = forbidden_modules()
        if gone:
            log(f"modules that the benchmark may not load are loaded: {gone}")
            return None
        t0 = time.perf_counter()
        numbers = check.judge(run, outputs, args.seed, devices[0])
        log(f"[check] judged in {time.perf_counter() - t0:.1f} s; passes {passes}")
        limits = spec["limits"].get("limits", {})
        verdict = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
        correct = bool(limits) and all(
            v["limit"] is not None and np.isfinite(v["value"]) and v["value"] <= v["limit"]
            for v in verdict.values())
        line = {"correct": correct, "attempted": ctx["window_fields"],
                "failed": 0 if correct else ctx["window_fields"], "metrics": metrics,
                "device": result_device}
        if args.trace and ctx["trace"]:
            line["breakdown"] = {"device_ops": ctx["trace"]["top_ops"],
                                 "idle_gaps": ctx["trace"]["idle_gaps"]}
        line["check"] = verdict
        return line
    finally:
        if run is not None:
            run.oracle.close()
        shutil.rmtree(tmp, ignore_errors=True)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, default=0, choices=(0, 1))
    p.add_argument("--size", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--cells", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--fields", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--readings", default="", help=argparse.SUPPRESS)
    p.add_argument("--dump", default="", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    try:
        import torch
    except ImportError as e:
        log(f"no torch: {e}")
        return 2
    try:
        spec = load_cell(args.workload)
    except (OSError, StopIteration, KeyError) as e:
        log(f"cannot load the cell {args.workload!r}: {e!r}")
        return 2
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"the cell needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    line = run_cell(args, [f"cuda:{i}" for i in range(chips)], t_start)
    if args.readings:
        return 0
    if line is None:
        return 3
    for name, v in line["check"].items():
        log(f"check {name}: {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0
