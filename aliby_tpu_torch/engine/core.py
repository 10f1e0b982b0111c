"""Pipeline runtime: the dict-programmed per-timepoint engine (counterpart
of ``aliby_tpu/engine/core.py``).

The pipeline-dict schema is the reference's public config language
(``pipe_core.py``): ``steps`` (ordered name->params; order = execution
order; semantics by name prefix), ``passed_data`` (kwargs from producers'
last outputs, with dict-key plucking and the 2-tp tile-major reshape for
``track``), ``passed_methods`` (positional args from a method on a prior
step object: the tile->segment pixel hand-off), ``save``/``save_interval``
(per-tp .npz checkpoints), ``retain`` (history truncation), ``ntps``,
``global_steps`` + ``global_passed_data`` (post-run whole-movie steps fed by
in-memory or ``from_disk:`` fetchers).

Device work runs on ``device`` (``cuda`` unless the caller passes
``device="cpu"``): :func:`run_pipeline_return_state` hands it to every step
initializer and to the compiled step. The profile of a position is kept as
numpy columns (:func:`profile_columns`), so the runner needs no pyarrow;
:func:`get_profiles_from_state` and :func:`finalize_position` import it to
build and write the parquet.
"""

from __future__ import annotations

import functools
import logging
import logging.handlers
import time
from pathlib import Path
from typing import Callable

import numpy as np

from aliby_tpu_torch.device import resolve_device
from aliby_tpu_torch.extract.extract import (
    OverlapTreeResult,
    extraction_columns,
    extraction_columns_overlap,
)
from aliby_tpu_torch.io.write import dispatch_write_fn, write_parquet
from aliby_tpu_torch.utils.timer import StepTimer

logger = logging.getLogger("aliby_tpu_torch")

_NET_ITEM = ("the remote clients and the embedder (net/, models/embedder.py: "
             "ROADMAP queue 1, item 8)")
METADATA_KEYS = [f"metadata_{k}" for k in ("tp", "tile", "object", "label")]


def configure_logging(log_path: str | Path, level: int = logging.DEBUG) -> None:
    """Per-position file logging: 10 MB rotation, like the reference's
    loguru sink (``pipe_core.py:37-46``) but on stdlib logging."""
    log_path = Path(log_path)
    log_path.parent.mkdir(parents=True, exist_ok=True)
    root = logging.getLogger("aliby_tpu_torch")
    root.setLevel(level)
    for h in list(root.handlers):
        if isinstance(h, logging.handlers.RotatingFileHandler):
            root.removeHandler(h)
    handler = logging.handlers.RotatingFileHandler(
        log_path, maxBytes=10 * 1024 * 1024, backupCount=7
    )
    handler.setFormatter(
        logging.Formatter("%(asctime)s | %(levelname)s | %(name)s - %(message)s")
    )
    root.addHandler(handler)


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------


def validate_pipeline(pipeline: dict) -> None:
    """Structural checks of the pipeline dict (``pipe_core.py:254-365``)."""
    if not isinstance(pipeline, dict):
        raise TypeError("Pipeline configuration must be a dictionary.")
    if not isinstance(pipeline.get("steps"), dict):
        raise ValueError(
            "Pipeline must contain a 'steps' dictionary mapping step names "
            "to parameters."
        )
    steps = pipeline["steps"]
    if not isinstance(pipeline.get("passed_data"), dict):
        raise ValueError("Pipeline must contain a 'passed_data' dictionary.")
    passed_data = pipeline["passed_data"]
    for target, deps in passed_data.items():
        if not isinstance(deps, (list, tuple)):
            raise TypeError(
                f"'passed_data' dependencies for step '{target}' must be a sequence."
            )
        for dep in deps:
            if not isinstance(dep, (list, tuple)) or len(dep) < 2:
                raise ValueError(
                    f"Invalid dependency format in 'passed_data' for "
                    f"'{target}': {dep}"
                )
            if dep[1] not in steps:
                raise ValueError(
                    f"Step '{target}' expects data from '{dep[1]}', but "
                    f"'{dep[1]}' is not defined in 'steps'."
                )
    passed_methods = pipeline.get("passed_methods", {})
    if not isinstance(passed_methods, dict):
        raise TypeError("'passed_methods' must be a dictionary.")
    for target, spec in passed_methods.items():
        if not isinstance(spec, (list, tuple)) or len(spec) < 2:
            raise ValueError(
                f"Invalid method dependency format for '{target}': {spec}"
            )
        if spec[0] not in steps:
            raise ValueError(
                f"Step '{target}' expects a method from '{spec[0]}', but "
                f"'{spec[0]}' is not defined in 'steps'."
            )
    save = pipeline.get("save")
    if save is not None:
        if not isinstance(save, (list, tuple, set)):
            raise TypeError("'save' must be a sequence of step names.")
        for s in save:
            if s not in steps and s not in pipeline.get("global_steps", {}):
                raise ValueError(
                    f"Step '{s}' listed in 'save' is not defined in the "
                    f"pipeline 'steps' or 'global_steps'."
                )
    if "save_interval" in pipeline:
        si = pipeline["save_interval"]
        if not isinstance(si, int) or isinstance(si, bool) or si < 1:
            raise ValueError(f"'save_interval' must be a positive int, got {si!r}.")
    retain = pipeline.get("retain", {})
    if not isinstance(retain, dict):
        raise TypeError("'retain' must be a dictionary mapping step name to int or 'all'.")
    for name, keep in retain.items():
        if name not in steps:
            raise ValueError(f"'retain' references step '{name}' not defined in 'steps'.")
        if keep != "all" and not (
            isinstance(keep, int) and not isinstance(keep, bool) and keep >= 0
        ):
            raise ValueError(
                f"'retain[{name}]' must be a non-negative int or 'all', got {keep!r}."
            )
        feeds_tracker = any(
            dep[1] == name
            for target, deps in passed_data.items()
            if target.startswith("track")
            for dep in deps
        )
        if feeds_tracker and isinstance(keep, int) and keep < 2:
            raise ValueError(
                f"'retain[{name}]' = {keep} is too small; per-tp 'track' "
                f"step reads the last 2 timepoints of '{name}'."
            )
    for name, params in steps.items():
        if not isinstance(params, dict):
            raise TypeError(f"Parameters for step '{name}' must be a dictionary.")
        if name.startswith("nahual") and "address" not in params:
            raise ValueError(
                f"Nahual-deployed step '{name}' must provide an 'address' parameter."
            )
    if pipeline.get("global_steps"):
        if "global_passed_data" not in pipeline:
            raise ValueError(
                "Pipeline defines 'global_steps' but is missing 'global_passed_data'."
            )
        if not isinstance(pipeline["global_passed_data"], dict):
            raise TypeError("'global_passed_data' must be a dictionary.")


# ---------------------------------------------------------------------------
# Per-timepoint execution
# ---------------------------------------------------------------------------


def _resolve_passed_data(pipeline: dict, state: dict, step_name: str) -> dict:
    deps = pipeline["passed_data"].get(step_name, ())
    kwargs = {}
    for dep in deps:
        kwd, producer, *rename = dep
        history = state["data"].get(producer, [])
        if not history:
            continue
        arg_name = rename[0] if rename else kwd
        if step_name.startswith("track") and kwd == "masks":
            # tracker wants the last 2 tps, tile-major
            recent = history[-2:]
            n_tiles = len(recent[-1])
            kwargs[arg_name] = [
                [tp_tiles[t] for tp_tiles in recent] for t in range(n_tiles)
            ]
        else:
            value = history[-1]
            if isinstance(value, dict):
                value = value[kwd]
            kwargs[arg_name] = value
    return kwargs


def pipeline_step(
    pipeline: dict,
    state: dict | None,
    steps_dir: str | Path | None,
    init_step_fn: Callable,
) -> dict:
    """Run one timepoint of every step, threading state."""
    if not state:
        state = {
            "tps": {name: 0 for name in pipeline["steps"]},
            "data": {},
            "fn": {},
            "timer": StepTimer(),
        }
    tp = next(iter(state["tps"].values()))
    steps = pipeline["steps"]
    passed_methods = pipeline.get("passed_methods", {})
    save_list = pipeline.get("save") or []
    save_interval = pipeline.get("save_interval", 1)

    for step_name, parameters in steps.items():
        state["data"].setdefault(step_name, [])
        if step_name not in state["fn"]:
            state["fn"][step_name] = init_step_fn(step_name, parameters, state["fn"])
        step = state["fn"][step_name]

        kwargs = _resolve_passed_data(pipeline, state, step_name)
        args = ()
        method_spec = passed_methods.get(step_name)
        if method_spec is not None and step_name.startswith("segment"):
            source, method = method_spec
            args = (getattr(state["fn"][source], method)(tp),)

        t0 = time.perf_counter()
        if hasattr(step, "run_tp"):
            result = step.run_tp(tp, *args, **kwargs)
        else:
            if step_name.startswith("track"):
                history = state["data"][step_name]
                result = step(kwargs.pop("masks"), state=history[-1] if history else None,
                              **kwargs)
            else:
                result = step(*args, **kwargs)
        state["timer"].add(step_name, time.perf_counter() - t0)

        if save_list and save_interval > 0 and (tp % save_interval) == 0 and step_name in save_list:
            write_fn = dispatch_write_fn(step_name)
            write_fn(result, steps_dir=steps_dir, subpath=step_name, tp=tp)
            logger.info("Saved %s tp %d under %s", step_name, tp, steps_dir)

        state["data"][step_name].append(result)
        state["tps"][step_name] = tp + 1

        # Tracking/lineage metadata must survive retain-trimming (the BABY
        # post-hook reads the FULL per-tp history; reference hooks per-tp,
        # pipe_baby.py:94-129). Metadata is tiny — keep it all.
        if step_name.startswith("segment") and isinstance(result, dict):
            state.setdefault("meta_history", {}).setdefault(
                step_name, []
            ).append(result.get("metadata"))

    # Memory hygiene: tile pixels are consumed within the tp; drop them.
    for step_name, history in state["data"].items():
        if step_name.startswith("tile") and history:
            entry = history[-1]
            if isinstance(entry, dict) and "pixels" in entry:
                del entry["pixels"]
    # Trim histories per retain config.
    for step_name, history in state["data"].items():
        keep = pipeline.get("retain", {}).get(step_name, "all")
        if isinstance(keep, int) and keep >= 0 and len(history) > keep:
            del history[: len(history) - keep]
    return state


def _should_compile(pipeline: dict, device) -> bool:
    """``pipeline["compiled"]`` wins when set (True/False). Unset means
    compile on ``cuda`` (one fused step a timepoint) and interpret on the
    CPU, as the reference does with its backend. Ineligible pipelines fall
    back to the interpreted loop either way (``try_compile`` returns None)."""
    flag = pipeline.get("compiled")
    if flag is not None:
        return bool(flag)
    return resolve_device(device).type == "cuda"


def _segment_results(state: dict) -> list:
    return [hist[-1] for name, hist in state["data"].items()
            if name.startswith("segment") and hist]


def run_pipeline_return_state(pipeline: dict, steps_dir: str | Path | None,
                              init_step_fn: Callable, device=None) -> dict:
    """Run every timepoint of one position; returns its state.

    ``init_step_fn`` is called as ``init_step_fn(name, parameters,
    other_steps, device=device)``. A compiled pipeline runs one fused step a
    timepoint (``movie: False``) or chunked whole-movie dispatches (the
    default when ``ntps > 1`` and every tracker is a stitch tracker;
    ``movie_chunk`` sets the chunk)."""
    from aliby_tpu_torch.engine.earlystop import EarlyStopMonitor

    device = resolve_device(device)
    validate_pipeline(pipeline)
    init_step_fn = functools.partial(init_step_fn, device=device)
    monitor = EarlyStopMonitor(pipeline.get("earlystop"))
    state: dict = {}

    if _should_compile(pipeline, device):
        from aliby_tpu_torch.engine.compiled import try_compile

        tiler = init_step_fn("tile", pipeline["steps"]["tile"], {})
        compiled = try_compile(pipeline, tiler, init_step_fn, device=device)
        if compiled is not None:
            state = {
                "tps": {n: 0 for n in pipeline["steps"]},
                "data": {},
                "fn": {"tile": tiler},
                "timer": StepTimer(),
            }
            ntps = pipeline.get("ntps", 1)
            if ntps > 1 and pipeline.get("movie", True) and compiled.movie_capable():
                t0 = time.perf_counter()
                compiled.run_movie(range(ntps), tiler, state, pipeline, steps_dir,
                                   monitor=monitor, chunk=pipeline.get("movie_chunk"))
                state["timer"].add("compiled_movie", time.perf_counter() - t0)
                return state
            for tp in range(ntps):
                t0 = time.perf_counter()
                compiled.run_tp(tp, tiler, state, pipeline, steps_dir)
                state["timer"].add("compiled_step", time.perf_counter() - t0)
                if monitor.enabled and monitor.should_stop(tp, _segment_results(state)):
                    break
            return state

    for tp in range(pipeline.get("ntps", 1)):
        state = pipeline_step(pipeline, state, steps_dir, init_step_fn)
        if monitor.enabled and monitor.should_stop(tp, _segment_results(state)):
            break
    return state


# ---------------------------------------------------------------------------
# Profiles assembly
# ---------------------------------------------------------------------------


def _masked_like(col: np.ndarray, n: int) -> np.ndarray:
    """``n`` missing values of ``col``'s type (nulls in the parquet)."""
    return np.ma.MaskedArray(np.zeros(n, col.dtype), mask=np.ones(n, bool))


def _concat_columns(tables: list[dict]) -> dict:
    """Row-concatenate column dicts; a column that a table lacks is missing
    (masked) on its rows, and columns keep their order of first appearance
    (``pa.concat_tables(..., promote_options="permissive")``)."""
    names: list[str] = []
    for t in tables:
        names += [n for n in t if n not in names]
    out = {}
    for n in names:
        like = next(t[n] for t in tables if n in t)
        parts = [t[n] if n in t else _masked_like(like, len(t["metadata_tile"])) for t in tables]
        if any(isinstance(p, np.ma.MaskedArray) for p in parts):
            out[n] = np.ma.concatenate(parts)
        else:
            out[n] = np.concatenate(parts)
    return out


def _join_on_metadata(left: dict, right: dict, keys: list[str]) -> dict:
    """Left-outer join on the (unique-keyed) metadata columns by direct key
    alignment: the right side's other columns are appended to the left in
    its row order, missing where the left row has no match."""
    row_of = {}
    for i, kt in enumerate(zip(*(right[k].tolist() for k in keys))):
        if kt in row_of:
            raise ValueError(f"duplicate metadata key {kt} in a profile table")
        row_of[kt] = i
    found = [row_of.get(kt) for kt in zip(*(left[k].tolist() for k in keys))]
    idx = np.asarray([0 if i is None else i for i in found], np.int64)
    missing = np.asarray([i is None for i in found], bool)
    out = dict(left)
    for name, col in right.items():
        if name in keys:
            continue
        picked = col[idx] if len(col) else np.zeros(len(idx), col.dtype)
        out[name] = np.ma.MaskedArray(picked, mask=missing) if missing.any() else picked
    return out


def _format_profile_table(step_name: str, tp: int, output):
    """One (feature step, tp) output -> its decorated wide columns, or
    ``False`` when the tp produced no rows (None stays the cache-miss
    sentinel)."""
    if isinstance(output, OverlapTreeResult):
        cols = extraction_columns_overlap(output)  # metadata columns named already
    else:
        cols = extraction_columns(output)
        renames = {"tile": "metadata_tile", "label": "metadata_label"}
        cols = {renames.get(k, k): v for k, v in cols.items()}
    n = len(cols["metadata_tile"])
    if not n:
        return False
    if not 0 <= tp <= 255:
        raise ValueError(f"metadata_tp is uint8; tp {tp} does not fit")
    cols["metadata_object"] = np.asarray([step_name.split("_")[-1]] * n)
    cols["metadata_tp"] = np.full(n, tp, np.uint8)
    return cols


def profile_columns(state: dict, pipeline: dict) -> dict:
    """The position's wide per-object profile as ordered numpy columns
    (``pipe_core.py:453-512``): each extract*/embed* step x tp gives a wide
    table with metadata columns (tile/label/object/tp); the tps of one step
    prefix are stacked, and the prefixes are joined on the metadata key.
    ``{}`` when no step produced a row."""
    feature_steps = [s for s in pipeline["steps"]
                     if s.startswith("extract") or s.startswith("nahual_embed")
                     or s.startswith("embed")]
    per_prefix: dict[str, list] = {s.split("_")[0]: [] for s in feature_steps}
    cache = state.get("profile_tables") or {}
    for step_name in feature_steps:
        prefix = step_name.split("_")[0]
        for tp, output in enumerate(state["data"].get(step_name, [])):
            table = cache.get((step_name, tp))
            if table is None:
                table = _format_profile_table(step_name, tp, output)
            if table is not False:
                per_prefix[prefix].append(table)
    wide = [_concat_columns(tables) for tables in per_prefix.values() if tables]
    if not wide:
        return {}
    profiles = wide[0]
    for table in wide[1:]:
        profiles = _join_on_metadata(profiles, table, METADATA_KEYS)
    return profiles


def get_profiles_from_state(state: dict, pipeline: dict):
    """:func:`profile_columns` as a ``pyarrow.Table`` (the reference's
    return value; an empty table with the four metadata columns when no
    step produced a row)."""
    import pyarrow as pa

    cols = profile_columns(state, pipeline)
    if not cols:
        return pa.Table.from_pylist([], schema=pa.schema([
            pa.field("metadata_tile", pa.int64()),
            pa.field("metadata_label", pa.int64()),
            pa.field("metadata_object", pa.string()),
            pa.field("metadata_tp", pa.int64()),
        ]))
    return pa.Table.from_pydict(cols)


def cache_profile_table(state: dict, pipeline: dict, step_name: str) -> None:
    """Format the latest tp's profile columns for ``step_name`` now and stash
    them under ``state["profile_tables"][(step, tp)]``, so that the finalize
    tail does not build them after the device has gone idle (callers invoke
    this from bookkeeping that overlaps device time). Skipped when retain
    trims this step's history: profiles number tps by list index."""
    keep = pipeline.get("retain", {}).get(step_name, "all")
    if isinstance(keep, int):
        return
    history = state["data"].get(step_name)
    if not history:
        return
    tp = len(history) - 1
    cache = state.setdefault("profile_tables", {})
    cache[(step_name, tp)] = _format_profile_table(step_name, tp, history[-1])


# ---------------------------------------------------------------------------
# Global steps IO
# ---------------------------------------------------------------------------


def _load_per_tp_masks(step_dir: Path) -> list[np.ndarray]:
    """Read per-tp .npz checkpoints (both layouts — ``pipe_core.py:546-571``).

    Returns one ``(F, Y, X)`` array per timepoint covering EVERY tile (the
    reference — and round 1 here — kept only tile 0, silently dropping the
    rest of a trap grid). Layered (BABY) tiles are max-projected to 2-D,
    which is lossless for labels (DSatur layering guarantees no per-pixel
    overlap, reference ``segment/dispatch.py:57-60``).
    """
    files = sorted(Path(step_dir).glob("*.npz"))
    if not files:
        raise FileNotFoundError(
            f"No per-tp .npz files found under {step_dir}; ensure this step "
            f"is listed in pipeline['save']."
        )
    out = []
    for f in files:
        with np.load(f) as npz:
            keys = list(npz.keys())
            tile_keys = sorted(
                (k for k in keys if k.startswith("tile_")),
                key=lambda k: int(k.split("_")[1]),
            )
            if tile_keys:
                tiles = [npz[k] for k in tile_keys]
                tiles = [t.max(axis=0) if t.ndim == 3 else t for t in tiles]
                out.append(np.stack(tiles))
            elif keys == ["arr_0"]:
                arr = npz["arr_0"]
                out.append(arr if arr.ndim == 3 else arr[None])
            else:
                raise ValueError(f"Unrecognised .npz layout in {f}: keys={keys}")
    return out


def get_step_output(
    state_data: dict,
    fetchers,
    steps_dir: Path | None = None,
) -> np.ndarray:
    """Aggregate whole-movie outputs from memory, disk, or callables."""
    combined = []
    for fetcher in fetchers:
        if isinstance(fetcher, str):
            if fetcher.startswith("from_disk:"):
                if steps_dir is None:
                    raise ValueError(
                        "from_disk fetcher requires steps_dir; pass it "
                        "through get_step_output(..., steps_dir=...)"
                    )
                name = fetcher.removeprefix("from_disk:")
                combined.append(_load_per_tp_masks(Path(steps_dir) / name))
            else:
                # in-memory per-tp entries: keep ALL tiles, mirroring the
                # disk path's (F, Y, X) layout
                per_tp = []
                for x in state_data[fetcher]:
                    if isinstance(x, dict) and "masks" in x:
                        tiles = [np.asarray(m) for m in x["masks"]]
                        tiles = [
                            t.max(axis=0) if t.ndim == 3 else t for t in tiles
                        ]
                        per_tp.append(np.stack(tiles))
                    elif isinstance(x, (list, tuple)):
                        per_tp.append(np.stack([np.asarray(m) for m in x]))
                    else:
                        arr = np.asarray(x)
                        per_tp.append(arr if arr.ndim == 3 else arr[None])
                combined.append(per_tp)
        elif callable(fetcher):
            got = np.asarray(fetcher(state_data))
            # normalize to the (T, F, Y, X) per-fetcher contract
            combined.append(got[:, None] if got.ndim == 3 else got)
        else:
            raise Exception(
                f"Invalid type, expected Callable or string, got {type(fetcher)}"
            )
    return np.asarray(combined)


# ---------------------------------------------------------------------------
# Step initializers shared across pipeline flavours
# ---------------------------------------------------------------------------


def _init_tile(step_name: str, parameters: dict, device=None):
    """Build the image (dispatch_image), then the tiler (dispatch_tiler);
    trap detection runs on ``device``."""
    from aliby_tpu_torch.io.image import dispatch_image
    from aliby_tpu_torch.tile.tiler import dispatch_tiler

    params = dict(parameters)
    image_kwargs = dict(params.pop("image_kwargs"))
    source = image_kwargs.pop("source")
    image = dispatch_image(source)(source, **image_kwargs)
    kind = params.pop("kind", "crop" if step_name.startswith("tile_crop") else "trap")
    return dispatch_tiler(kind, device=device, **params)(image)


def _init_extract(step_name: str, parameters: dict, overlap: bool = False, device=None):
    """The step's tree over one timepoint's masks: 2-D label maps, or with
    ``overlap`` (the BABY flavour) layered, possibly overlapping ones."""
    from aliby_tpu_torch.extract.extract import process_tree_masks, process_tree_masks_overlap

    kwargs = dict(parameters.get("kwargs", {}))
    cp_kwargs = kwargs.pop("cp_measure_kwargs", None)
    fn = process_tree_masks_overlap if overlap else process_tree_masks
    return functools.partial(fn, tree=parameters["tree"],
                             cp_measure_kwargs=cp_kwargs, device=device, **kwargs)


def _init_extract_multi(step_name: str, parameters: dict, device=None):
    return _init_extract(step_name, parameters, overlap=False, device=device)


def _init_embed(step_name: str, parameters: dict, device=None):
    raise NotImplementedError(f"step {step_name!r}: {_NET_ITEM}")


def _init_nahual_embed(step_name: str, parameters: dict, device=None):
    raise NotImplementedError(f"step {step_name!r}: {_NET_ITEM}")


def _init_nahual_track(step_name: str, parameters: dict, device=None):
    raise NotImplementedError(f"step {step_name!r}: {_NET_ITEM}")


# ---------------------------------------------------------------------------
# Run + post
# ---------------------------------------------------------------------------


def _run_pipeline_and_post_impl(pipeline: dict, pipeline_name: str, output_path: str | Path,
                                init_step_fn: Callable, post_state_hook: Callable | None = None,
                                overwrite: bool = False, device=None):
    """Full per-position run: tp loop, profiles parquet, global steps.

    Layout (``pipe_core.py:381-450``): ``steps/<pos>/<step>/<tp>.npz``,
    ``profiles/<pos>.parquet`` (zstd), global-step parquets in their own
    subdirs. An existing profiles parquet skips the position unless
    ``overwrite``.
    """
    output_path = Path(output_path)
    steps_dir = output_path / "steps" / pipeline_name
    profiles_file = output_path / "profiles" / f"{pipeline_name}.parquet"
    if profiles_file.exists() and not overwrite:
        logger.info("Skipping %s", pipeline_name)
        return None, None
    state = run_pipeline_return_state(pipeline, steps_dir, init_step_fn, device=device)
    return finalize_position(state, pipeline, pipeline_name, output_path, init_step_fn,
                             post_state_hook=post_state_hook, device=device)


def finalize_position(state: dict, pipeline: dict, pipeline_name: str, output_path: str | Path,
                      init_step_fn: Callable, post_state_hook: Callable | None = None,
                      device=None):
    """Profiles parquet + post hook + global steps for a completed state.

    Shared by the per-position runner above and the mesh runner
    (``parallel/pipeline_mesh.py``), which builds the states of many
    positions from batched device calls before finalizing each."""
    import pyarrow.parquet as pq

    output_path = Path(output_path)
    steps_dir = output_path / "steps" / pipeline_name
    profiles_file = output_path / "profiles" / f"{pipeline_name}.parquet"

    profiles = get_profiles_from_state(state, pipeline)
    profiles_file.parent.mkdir(parents=True, exist_ok=True)
    # zstd as the reference (pipe_core.py:413); column statistics and
    # dictionary encoding cost a pass per column chunk on these short, wide
    # tables, and no reader consults them
    pq.write_table(profiles, profiles_file, compression="zstd", write_statistics=False,
                   use_dictionary=False)

    if post_state_hook is not None:
        post_state_hook(state, pipeline, pipeline_name, output_path)

    post_results = {}
    global_steps = pipeline.get("global_steps", {})
    if global_steps:
        gpd = pipeline.get("global_passed_data", {})
        for gs_name, gs_params in global_steps.items():
            gs_fn = init_step_fn(gs_name, gs_params, state["fn"], device=device)
            for feed_name, fetchers in gpd.items():
                if not feed_name.startswith(gs_name):
                    continue
                stacked = get_step_output(state["data"], fetchers, steps_dir=steps_dir)
                result = gs_fn(stacked)
                post_results[feed_name] = result
                if gs_name in (pipeline.get("save") or []):
                    write_parquet(result, output_path=output_path, subpath=gs_name,
                                  filename=f"{pipeline_name}_{feed_name}")
    logger.info("Timing summary %s: %s", pipeline_name, state["timer"].summary())
    return profiles, post_results


# ---------------------------------------------------------------------------
# Builder helper: trackastra-style global tracking attachment
# ---------------------------------------------------------------------------


def _attach_trackastra(
    base_pipeline: dict,
    channels_to_segment,
    trackastra_address: str | None,
    trackastra_parameters: dict | None,
) -> None:
    """Wire a whole-movie tracking global step in place
    (``pipe_core.py:579-612``). ``address=None`` selects the in-process
    linker (``track.linker``); a remote server needs ``net/`` (the builder
    refuses an address)."""
    seg_steps = [f"segment_{obj}" for obj in channels_to_segment]
    for seg in seg_steps:
        if seg not in base_pipeline["save"]:
            base_pipeline["save"].append(seg)
    gs_name = "nahual_trackastra" if trackastra_address else "track_global"
    base_pipeline["save"].append(gs_name)
    base_pipeline["global_steps"] = {
        gs_name: dict(
            address=trackastra_address,
            parameters=trackastra_parameters or {},
        )
        if trackastra_address
        else dict(parameters=trackastra_parameters or {}),
    }
    base_pipeline["global_passed_data"] = {
        f"{gs_name}_{obj}": (f"from_disk:segment_{obj}",)
        for obj in channels_to_segment
    }
    retain = base_pipeline.setdefault("retain", {})
    for seg in seg_steps:
        retain.setdefault(seg, 2)
    retain.setdefault("tile", 1)
