"""The output check that decides a run's ``correct``.

After the window the benchmark compares what the timed path produced on a
seeded sample of the plate's fields with the plain reference
(``gpubench/reference/``):

- ``unet_rel_rms``: the network's output on each sampled field and object,
  as the timed path computed it (copied to the host during the window),
  against the reference network's f32 forward (TF32 off) of the
  benchmark's own pixels, normalised again: RMS of the difference over RMS
  of the reference, the worst (field, object);
- ``mask_mismatch``: the masks the timed path wrote against the reference's
  mask reconstruction of that same network output: the share of pixels
  whose label differs, over every sampled (field, object);
- ``feat.<family>``: each family of the cell's bank, as written to the
  profiles parquet, against the per-object oracle computed on the masks
  the timed path wrote and the benchmark's pixels, on a seeded sample of
  the objects: over the family's columns, the largest of each column's
  0.9 quantile over the objects of its error in units of its tolerance;
  and ``feat.one_sided_nan``, the pairs that are NaN on one side alone (a
  missing row among them): ``feature_numbers``.

The reference follows the network's output from the program's own state
(the mask reconstruction starts from the output the timed path computed),
and checks the network itself apart (``unet_rel_rms``); the features start
from the program's masks, which ``mask_mismatch`` checks.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import torch

from gpubench.plate import as_read, channel_index
from gpubench.reference import dynamics, unet
from gpubench.reference import features as O
from gpubench.reference import tolerances

MARGIN = 2  # pixels of background around an object's crop
QUANTILE = 0.9  # a feature column's error: this quantile of its errors over the objects
_STACKS: dict = {}  # field index -> (5, H, W) uint16 in the program's channel order


# --- what the timed path produced ---------------------------------------


def sample_positions(keys: list[str], seed: int, strata: int) -> list[str]:
    """One position drawn from the seed in each of ``strata`` equal runs of
    the plate's positions (in the order the program runs them), so that
    every half of every call of the plate is sampled."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0xC4EC]))
    bounds = np.linspace(0, len(keys), strata + 1).round().astype(int)
    return [keys[rng.integers(a, b)] for a, b in zip(bounds[:-1], bounds[1:]) if b > a]


class Capture:
    """Copies the network output of the sampled positions to pinned host
    memory as the timed path computes it (non-blocking copies on the
    computing stream; nothing waits for them inside the window).

    The rows of a call are found from the runner's plan: a pass runs its
    positions in rounds of ``G`` (``pipeline_mesh.plan_calls``), a round's
    positions split in contiguous groups over the dp shards (the first
    groups one larger), and a shard's call segments the ``P`` positions of
    its group for each object, object-major."""

    def __init__(self, keys: list[str], sampled: list[str], devices: list, n_objects: int,
                 shape: tuple[int, int]):
        self.keys, self.devices, self.n_objects = keys, [str(d) for d in devices], n_objects
        pin = torch.cuda.is_available()
        self.out = {(k, o): torch.empty((shape[0], shape[1], 3), dtype=torch.float32,
                                        pin_memory=pin)
                    for k in sampled for o in range(n_objects)}
        self.sampled = set(sampled)
        self.G = None
        self._calls = {}
        self._lock = threading.Lock()
        self._local = threading.local()
        self._saved = []

    def new_pass(self):
        self._calls = {}

    def _positions(self, shard: int, call: int) -> list[str]:
        dp = len(self.devices)
        group = self.keys[call * self.G:(call + 1) * self.G]
        q, r = divmod(len(group), dp)
        sizes = [q + 1] * r + [q] * (dp - r)
        start = sum(sizes[:shard])
        return group[start:start + sizes[shard]]

    def __enter__(self):
        from aliby_tpu_torch.models import segment
        from aliby_tpu_torch.parallel import pipeline_mesh

        plan = pipeline_mesh.plan_calls

        def plan_calls(*a, **k):
            G, C = plan(*a, **k)
            self.G = G
            return G, C

        engine = segment.CellposeTorch
        seg_all, forward = engine._segment_all, engine._forward
        cap = self

        def segment_all(self_, images):
            shard = cap.devices.index(str(images.device))
            with cap._lock:
                call = cap._calls.get(shard, 0)
                cap._calls[shard] = call + 1
            cap._local.rows = cap._positions(shard, call)
            try:
                return seg_all(self_, images)
            finally:
                cap._local.rows = None

        def _forward(self_, x):
            pred = forward(self_, x)
            rows = getattr(cap._local, "rows", None)
            if rows:
                P = len(rows)
                for o in range(cap.n_objects):
                    for j, key in enumerate(rows):
                        if key in cap.sampled:
                            H, W = cap.out[(key, o)].shape[:2]
                            cap.out[(key, o)].copy_(pred[o * P + j, :H, :W], non_blocking=True)
            return pred

        pipeline_mesh.plan_calls = plan_calls
        engine._segment_all, engine._forward = segment_all, _forward
        self._saved = [(pipeline_mesh, "plan_calls", plan), (engine, "_segment_all", seg_all),
                       (engine, "_forward", forward)]
        return self

    def __exit__(self, *exc):
        for obj, name, fn in self._saved:
            setattr(obj, name, fn)


def read_masks(out_dir: Path, key: str, objects: list[str]) -> list[np.ndarray]:
    """The (H, W) masks a pass wrote for a position, one an object."""
    masks = []
    for obj in objects:
        with np.load(Path(out_dir) / "steps" / key / f"segment_{obj}" / "0000.npz") as z:
            arr = z["arr_0"] if "arr_0" in z else np.stack([z[k] for k in sorted(z.keys())])
        masks.append(np.asarray(arr).reshape(arr.shape[-2:]).astype(np.int32))
    return masks


def read_profiles(out_dir: Path, key: str) -> dict:
    import pyarrow.parquet as pq

    table = pq.read_table(Path(out_dir) / "profiles" / f"{key}.parquet")
    return {n: table.column(n).to_numpy(zero_copy_only=False) for n in table.column_names}


# --- the reference ---------------------------------------------------------


class Reference:
    """The configuration's network in plain PyTorch, on ``device``."""

    def __init__(self, config: dict, device, cpnet_state: dict | None = None):
        net = config["network"]
        self.config = config
        if net["kind"] == "cellposenet":
            root = Path(__file__).resolve().parents[1]
            self.forward = unet.FlagshipUNet(unet.read_msgpack_tree(root / net["weights"]),
                                             device)
        else:
            self.forward = unet.CPnetForward(cpnet_state, net["nbase"], device)
        self.device = device

    def output(self, plane: np.ndarray, precision: str = "f32") -> torch.Tensor:
        """(H, W) raw plane -> (3, H, W) f32 on the device."""
        return self.forward(unet.network_input(plane).to(self.device), precision)[0]

    def masks(self, pred: torch.Tensor, dtype=torch.float32):
        """(labels, the labels whose QC error the reference cannot place
        on a side of the threshold at float32's resolution)."""
        seg = self.config["segmenter"]
        return dynamics.masks_from_output(
            pred.to(self.device), n_iter=seg["flow_iters"], max_labels=seg["max_labels"],
            min_size=seg["min_size"], flow_threshold=seg["flow_threshold"],
            cellprob_threshold=seg["cellprob_threshold"], dtype=dtype)


def _rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float(torch.sqrt(((a - b) ** 2).mean()) / torch.sqrt((b ** 2).mean()).clamp_min(1e-30))


# --- features --------------------------------------------------------------


def _family(column: str) -> tuple[str, str, tuple] | None:
    """A profile column -> (family, feature name, channels), or None for
    metadata."""
    parts = column.split("/")
    if column.startswith("metadata_") or len(parts) < 4:
        return None
    if parts[0].startswith("("):
        a, b = (int(v) for v in parts[0].strip("()").split(","))
        return "coloc", parts[-1], (a, b)
    chans = () if parts[0] == "None" else (int(parts[0]),)
    return parts[2], parts[-1], chans


def round_bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even), in
    NumPy: the workers are forked and use no torch (OpenMP after a fork
    can hang)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    u = (u + (((u >> 16) & 1) + 0x7FFF)) & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def _object_features(job) -> dict:
    """The oracle's value of each feature column of one object (a worker
    process; the pixels are the benchmark's, inherited at fork)."""
    field, crop, y0, x0, columns, edge, rounding = job
    stack = _STACKS[field].astype(np.float64)
    if rounding == "bf16":
        stack = round_bf16(stack.astype(np.float32)).astype(np.float64)
    h, w = crop.shape
    y1, x1 = y0 + h, x0 + w
    full = np.zeros((y1, x1), bool)  # the object at its place in the image, from the origin
    full[y0:y1, x0:x1] = crop
    cache, out = {}, {}

    def img(c, origin=False):
        return stack[c, :y1, :x1] if origin else stack[c, y0:y1, x0:x1]

    for column, (fam, name, ch) in columns.items():
        ck = (fam, ch) if fam != "coloc" else (fam, ch, column.split("/")[3])
        if ck not in cache:
            if fam == "sizeshape":
                cache[ck] = O.o_sizeshape(full)
            elif fam == "feret":
                mx, mn = O.o_feret(crop)
                cache[ck] = {"MaxFeretDiameter": mx, "MinFeretDiameter": mn}
            elif fam == "intensity":
                cache[ck] = O.o_intensity(full, img(ch[0], origin=True), edge_measurements=edge)
            elif fam == "texture":
                cache[ck] = O.o_texture(crop, img(ch[0]))
            elif fam == "zernike":
                cache[ck] = {f"Zernike_{n}_{m}": v for (n, m), v in O.o_zernike(crop).items()}
            elif fam == "radial_zernikes":
                im = img(ch[0])
                wgt = im / max(float(im[crop].sum()), 1e-12)
                cache[ck] = {f"RadialZernike_{n}_{m}": v
                             for (n, m), v in O.o_zernike(crop, weight=wgt).items()}
            elif fam == "radial_distribution":
                cache[ck] = O.o_radial_distribution(crop, img(ch[0]))
            elif fam == "coloc":
                fn = getattr(O, f"o_{column.split('/')[3]}")
                cache[ck] = fn(crop, img(ch[0]), img(ch[1]))
            else:
                raise KeyError(f"no oracle for the feature family {fam!r}")
        value = float(cache[ck].get(name, np.nan))
        if rounding == "bf16":  # a bfloat16 pass's results
            value = float(round_bf16(np.float32(value)))
        out[column] = value
    return out


def _noop(_):
    return None


class FeatureOracle:
    """A pool of worker processes holding the plate's pixels. Made before
    the card is touched (the workers are forked)."""

    def __init__(self, stacks: dict, workers: int | None = None):
        """``stacks``: {field index: (5, H, W) stack in ``STAINS`` order}."""
        _STACKS.clear()
        _STACKS.update({k: as_read(s) for k, s in stacks.items()})
        import multiprocessing

        n = workers or min(8, os.cpu_count() or 1)
        self.pool = ProcessPoolExecutor(n, mp_context=multiprocessing.get_context("fork"))
        # a fork pool forks every worker at its first task: make that now,
        # before the card and the program's threads exist in this process
        list(self.pool.map(_noop, range(n)))

    def close(self):
        self.pool.shutdown(wait=True, cancel_futures=True)

    def values(self, jobs):
        return list(self.pool.map(_object_features, jobs))


def object_jobs(field: int, labels: np.ndarray, picked, columns: dict, edge: bool,
                rounding: str = "f32") -> list:
    jobs = []
    for lab in picked:
        ys, xs = np.nonzero(labels == lab)
        y0, x0 = max(int(ys.min()) - MARGIN, 0), max(int(xs.min()) - MARGIN, 0)
        y1 = min(int(ys.max()) + MARGIN + 1, labels.shape[0])
        x1 = min(int(xs.max()) + MARGIN + 1, labels.shape[1])
        jobs.append((field, labels[y0:y1, x0:x1] == lab, y0, x0, columns, edge, rounding))
    return jobs


def pair_errors(pairs: dict) -> tuple[list, np.ndarray, np.ndarray]:
    """{column: (program values, oracle values)} over the sampled objects
    -> (columns, (objects, columns) errors, (objects, columns) one-sided
    NaNs).

    Each (object, column) pair's error is taken in units of its column's
    tolerance (``reference/tolerances.py``; 1 is the golden gate): the
    difference over the column's absolute bound, or over its relative bound
    times the column's scale, the largest oracle magnitude over the sample
    (a profile is read column by column, so a difference counts against
    the column's values, not against one object's value near zero); 0
    where either side is NaN."""
    columns = list(pairs)
    n = len(next(iter(pairs.values()))[0]) if pairs else 0
    err = np.zeros((n, len(columns)))
    one = np.zeros((n, len(columns)), bool)
    for j, column in enumerate(columns):
        _, name, _ = _family(column)
        got, want = (np.asarray(v, np.float64) for v in pairs[column])
        nan_g, nan_w = np.isnan(got), np.isnan(want)
        one[:, j] = nan_g ^ nan_w
        kind, bound = tolerances.bound_for(name)
        if kind == "rel":
            finite = np.isfinite(want)
            bound *= max(float(np.abs(want[finite]).max()) if finite.any() else 0.0, 1e-12)
        err[:, j] = np.where(nan_g | nan_w, 0.0, np.abs(got - want) / bound)
    return columns, err, one


def feature_numbers(pairs: dict, left_out=()) -> dict:
    """{column: (program values, oracle values)} -> {number: value}.

    ``feat.<family>``: over the family's columns, the largest of each
    column's ``QUANTILE`` quantile of its errors over the objects
    (``pair_errors``), so that a fault in one column of a tenth of the
    objects or more shows whole; columns whose feature name is in
    ``left_out`` (the cell's limits file) are not in it.
    ``feat.one_sided_nan``: the pairs that are NaN on one side alone, a
    missing profile row counting each of its columns (exact: limit 0)."""
    columns, err, one = pair_errors(pairs)
    high = (np.quantile(err, QUANTILE, axis=0, method="higher") if len(err)
            else np.zeros(len(columns)))
    numbers: dict = {}
    for j, column in enumerate(columns):
        fam, name, _ = _family(column)
        key = f"feat.{fam}"
        numbers[key] = max(numbers.get(key, 0.0),
                           0.0 if name in left_out else float(high[j]))
    numbers = dict(sorted(numbers.items()))
    numbers["feat.one_sided_nan"] = float(one.sum())
    return numbers


# --- the comparison --------------------------------------------------------


def collect_outputs(run, capture: Capture, sampled: list[str], out_dir: Path) -> dict:
    """What the timed path produced for the sampled positions: the network
    output (host copies), the masks and the profile rows it wrote."""
    return {key: {"pred": [capture.out[(key, o)] for o in range(len(run.objects))],
                  "masks": read_masks(out_dir, key, run.objects),
                  "profile": read_profiles(out_dir, key)}
            for key in sampled}


def pick_objects(masks: np.ndarray, seed: int, key: str, o: int, n: int) -> list[int]:
    """Up to ``n`` of a mask's labels, drawn from the seed."""
    labels = np.unique(masks)
    labels = labels[labels > 0]
    rng = np.random.default_rng(np.random.SeedSequence(
        [int(seed), o, *(ord(c) for c in key)]))
    return sorted(rng.choice(labels, min(n, len(labels)), replace=False).tolist())


def control_precision(config: dict) -> str:
    """The nearest precision below the network's: fp8 under bf16, TF32
    under f32 with TF32 off."""
    return {"bfloat16": "fp8", "float32": "tf32"}[config["network"]["dtype"]]


def judge(run, outputs: dict, seed: int, device, control: bool = False,
          details: dict | None = None) -> dict:
    """The numbers compared. Each stage is judged on the input the timed
    path gave it: the network on the benchmark's pixels, the mask
    reconstruction on the network output the timed path computed, the
    features on the masks it wrote. ``control``: at each stage the
    reference one precision down stands in the program's place (the
    network in ``control_precision``, the reconstruction in bfloat16, the
    features from bfloat16 pixels with bfloat16 results), judged the same
    way. ``details``, if given, receives the feature pairs compared and the
    sampled objects' names."""
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    config, traffic = run.config, run.traffic
    ref = Reference(config, device, run.cpnet_state)
    edge = (traffic.get("cp_measure_feature_kwargs") or {}).get("intensity", {}).get(
        "edge_measurements", True)
    worst_unet, mismatch, total = 0.0, 0, 0
    want_jobs, got_jobs, got_rows, object_ids = [], [], [], []
    low = control_precision(config)
    for key, out in outputs.items():
        stack = as_read(run.stacks[key])
        profile = out["profile"]
        columns = {c: f for c in profile if (f := _family(c)) is not None}
        for o, obj in enumerate(run.objects):
            plane = stack[channel_index(config["segment"][obj])]
            want = ref.output(plane)
            pred = out["pred"][o].to(ref.device).permute(2, 0, 1)
            worst_unet = max(worst_unet, _rel_rms(ref.output(plane, low) if control else pred,
                                                  want))
            ref_masks, undecided = ref.masks(pred)
            masks = ref.masks(pred, dtype=torch.bfloat16)[0] if control else out["masks"][o]
            differ = dynamics.canonical(masks) != dynamics.canonical(ref_masks)
            mismatch += int((differ & ~undecided).sum())
            total += masks.size
            prog_masks = out["masks"][o]
            picked = pick_objects(prog_masks, seed, key, o, traffic["check_objects"])
            field = run.field_index[key]
            want_jobs += object_jobs(field, prog_masks, picked, columns, edge)
            object_ids += [f"{key}/{obj}/{lab}" for lab in picked]
            if control:
                got_jobs += object_jobs(field, prog_masks, picked, columns, edge, rounding="bf16")
            else:
                sel = profile["metadata_object"] == obj
                for lab in picked:
                    row = np.flatnonzero(sel & (profile["metadata_label"] == lab))
                    got_rows.append({c: float(profile[c][row[0]]) if len(row) else np.nan
                                     for c in columns})
    want_vals = run.oracle.values(want_jobs)
    got_vals = run.oracle.values(got_jobs) if control else got_rows
    pairs: dict = {}
    for got, want in zip(got_vals, want_vals):
        for c, v in want.items():
            g, w = pairs.setdefault(c, ([], []))
            g.append(got.get(c, np.nan) if got.get(c) is not None else np.nan)
            w.append(v)
    numbers = {"unet_rel_rms": worst_unet, "mask_mismatch": mismatch / max(total, 1)}
    numbers.update(feature_numbers(pairs, run.limits.get("left_out", ())))
    if details is not None:
        details["pairs"] = pairs
        details["objects"] = object_ids
    return numbers
