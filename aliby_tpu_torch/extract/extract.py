"""Feature-tree compiler and batched executor (counterpart of
``aliby_tpu/extract/extract.py``).

A feature tree (``{channel: {z_reduction: [metrics]}}`` plus channel pairs
for colocalisation) flattens into instructions; :func:`compile_plan` dedups
them into plan entries over image slots (channel, z-reduction), and
:func:`tree_collect` evaluates every entry over a batch of label maps into
one ``(n_names, F, max_labels)`` block. :class:`FusedTreeResult` turns that
block back into the reference's ``(tileid_instructions, results)`` rows or
its wide table. :func:`process_tree_masks` is the interpreted path (one
step, one timepoint) and :func:`extraction_columns` /
:func:`format_extraction` the wide table, as numpy columns or as a pyarrow
table (pyarrow imported inside).

Every plan entry is ported: the cp_measure families (``sizeshape``,
``intensity``, ``feret`` and the families of ``extract/texture.py``), the
colocalisation pair (``corr``), and the yeast/trap entries: the cellfuns
scalars (``mask_scalar``, ``pixel_scalar``), ``localisation``, the tile
background (``trap``) and channel combinations (``comb_scalar``).
:func:`process_tree_masks_overlap` is the BABY path's form over layered,
possibly overlapping masks: each (tile, layer) is relabelled into a
virtual tile, the inverse label maps ride along, and
:func:`extraction_columns_overlap` / :func:`format_extraction_overlap`
restore the original labels.
"""

from __future__ import annotations

from itertools import product

import numpy as np
import torch

from aliby_tpu_torch.extract import cellfuns, features, localisation, texture
from aliby_tpu_torch.utils.profiling import span

# ---------------------------------------------------------------------------
# Tree flattening (reference extract.py:33-74 semantics)
# ---------------------------------------------------------------------------


def flatten(tree: dict, prefix: tuple = ()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, (*prefix, k)))
        else:
            out[(*prefix, k)] = v
    return out


def kv(flat: dict) -> list[tuple]:
    return [(*path, metric) for path, metrics in flat.items() for metric in metrics]


# ---------------------------------------------------------------------------
# Family registry
# ---------------------------------------------------------------------------

# cp_measure core families by name -> kind: "mask" -> (labels),
# "image" -> (labels, img)
_CP_FAMILY_KIND = {
    "sizeshape": "mask",
    "intensity": "image",
    "texture": "image",
    "granularity": "image",
    "zernike": "mask",
    "feret": "mask",
    "radial_distribution": "image",
    "radial_zernikes": "image",
}

# the scalar metric names of extract/cellfuns.py (the yeast/trap path)
MASK_METRICS = cellfuns.MASK_METRICS
PIXEL_METRICS = cellfuns.PIXEL_METRICS
TRAP_METRICS = cellfuns.TRAP_METRICS


def _cp_family_fn(name: str):
    if name == "sizeshape":
        return lambda labels, max_labels, **kw: features.sizeshape(labels, max_labels)
    if name == "intensity":
        return lambda labels, img, max_labels, **kw: features.intensity(
            labels, img, max_labels, edge_measurements=kw.get("edge_measurements", True)
        )
    if name == "feret":
        return lambda labels, max_labels, **kw: features.feret(labels, max_labels)
    if name == "zernike":
        return lambda labels, max_labels, **kw: texture.zernike(labels, max_labels)
    if name in ("texture", "granularity", "radial_distribution", "radial_zernikes"):
        fn = getattr(texture, name)
        return lambda labels, img, max_labels, **kw: fn(labels, img, max_labels)
    raise KeyError(name)


def _img2d(imgs, slot):
    im = imgs[slot]
    return im.amax(dim=1) if im.dim() == 4 else im


def _family(entry) -> str:
    """A plan entry's family: the cp_measure family's name, ``coloc`` for a
    colocalisation pair, else the entry's kind."""
    kind = entry[0]
    if kind in ("mask_family", "image_family"):
        return entry[1]
    return "coloc" if kind == "corr" else kind


def _entry_values(entry, labels, imgs, max_labels) -> dict:
    """Evaluate one plan entry over (F, H, W) labels -> {name: (F, L)}, in
    the span ``features.<family>``."""
    with span("features." + _family(entry), device=labels.device):
        kind = entry[0]
        if kind == "mask_family":
            _, metric, kw_items = entry
            return _cp_family_fn(metric)(labels, max_labels=max_labels, **dict(kw_items))
        if kind == "image_family":
            _, metric, kw_items, slot = entry
            return _cp_family_fn(metric)(labels, _img2d(imgs, slot), max_labels=max_labels,
                                         **dict(kw_items))
        if kind == "corr":
            _, metric, s0, s1 = entry
            return features.CORRELATION_FEATURES[metric](labels, _img2d(imgs, s0),
                                                         _img2d(imgs, s1), max_labels)
        if kind == "mask_scalar":
            return cellfuns.mask_metrics(labels, max_labels)
        if kind == "pixel_scalar":
            return cellfuns.pixel_metrics(labels, _img2d(imgs, entry[1]), max_labels)
        if kind == "localisation":
            _, metric, slot = entry
            return {metric: localisation.compute(metric, labels, imgs[slot], max_labels)}
        if kind == "trap":
            raw = cellfuns.background_metrics(labels, _img2d(imgs, entry[1]))
            return {k: v.unsqueeze(1).expand(v.shape[0], max_labels) for k, v in raw.items()}
        if kind == "comb_scalar":
            _, op, s0, s1 = entry
            a, b = _img2d(imgs, s0), _img2d(imgs, s1)
            combined = torch.nan_to_num(a / b if op == "div" else a + b)
            return cellfuns.pixel_metrics(labels, combined, max_labels)
        raise AssertionError(kind)


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------


def compile_plan(instructions: list[tuple], cpkw: dict):
    """Compile instructions into (deduped plan entries, image slots,
    per-instruction lookup), as the reference's ``compile_plan``."""
    slot_of: dict = {}

    def slot(ch, red):
        return slot_of.setdefault((ch, red), len(slot_of))

    entries: list = []
    entry_index: dict = {}

    def add_entry(e: tuple) -> int:
        if e not in entry_index:
            entry_index[e] = len(entries)
            entries.append(e)
        return entry_index[e]

    inst_lookup: dict = {}
    for inst in instructions:
        if len(inst) == 3:
            ch, red_z, metric = inst
            if metric in _CP_FAMILY_KIND:
                kind = _CP_FAMILY_KIND[metric]
                kw_items = tuple(sorted(cpkw.get(metric, {}).items()))
                if kind == "mask":
                    e = ("mask_family", metric, kw_items)
                else:
                    e = ("image_family", metric, kw_items, slot(ch, red_z))
                inst_lookup[inst] = ("dict", add_entry(e), None)
            elif metric in MASK_METRICS:
                inst_lookup[inst] = ("scalar", add_entry(("mask_scalar",)), metric)
            elif metric in PIXEL_METRICS:
                e = ("pixel_scalar", slot(ch, red_z))
                inst_lookup[inst] = ("scalar", add_entry(e), metric)
            elif metric in ("nuc_est_conv", "small_peaks_conv"):
                e = ("localisation", metric, slot(ch, red_z))
                inst_lookup[inst] = ("scalar", add_entry(e), metric)
            elif metric in TRAP_METRICS:
                e = ("trap", slot(ch, red_z))
                inst_lookup[inst] = ("scalar", add_entry(e), metric)
            else:
                raise KeyError(f"Unknown metric {metric!r}")
        else:  # multi-channel: (pair, red_ch, red_z, metric)
            pair, red_ch, red_z, metric = inst
            s0, s1 = slot(pair[0], red_z), slot(pair[1], red_z)
            if red_ch in ("None", None):
                inst_lookup[inst] = ("dict", add_entry(("corr", metric, s0, s1)), None)
            else:
                e = ("comb_scalar", red_ch, s0, s1)
                inst_lookup[inst] = ("scalar", add_entry(e), metric)
    return tuple(entries), slot_of, inst_lookup


def reduce_z_traced(img: torch.Tensor, method, dim: int = 0) -> torch.Tensor:
    """Z-reduction of ``img`` over ``dim`` (the reference's device-side
    ``reduce_z_traced``, batched)."""
    if method is None or method == "None":
        return img
    m = str(method)
    if m == "max":
        return img.amax(dim=dim)
    if m == "min":
        return img.amin(dim=dim)
    if m == "mean":
        return img.mean(dim=dim)
    if m == "median":
        return torch.quantile(img, 0.5, dim=dim, interpolation="midpoint")  # jnp.median
    if m in ("add", "sum"):
        return img.sum(dim=dim)
    raise KeyError(f"Unknown z-reduction {method!r}")


def tree_collect(plan_sig, labels: torch.Tensor, imgs, max_labels: int):
    """Evaluate every plan entry -> (sorted names ``"{entry}::{feature}"``,
    (n, F, max_labels) tensor).

    Two or more zernike-family entries (``zernike`` and the per-channel
    ``radial_zernikes``, which differ only in the integrand's weight) share
    one geometry and polynomial pass (``texture.zernike_family_multi``)."""
    outputs = {}
    zmask = [i for i, e in enumerate(plan_sig) if e[0] == "mask_family" and e[1] == "zernike"]
    zimg = [(i, e[3]) for i, e in enumerate(plan_sig)
            if e[0] == "image_family" and e[1] == "radial_zernikes"]
    handled: set = set()
    if len(zmask) + len(zimg) >= 2:
        with span("features.zernike", device=labels.device):
            if zimg:
                ims = torch.stack([_img2d(imgs, s) for _, s in zimg], dim=1)  # (F, C', H, W)
            else:
                ims = torch.zeros((labels.shape[0], 0) + labels.shape[1:], device=labels.device)
            mask_out, img_outs = texture.zernike_family_multi(labels, ims, bool(zmask),
                                                              max_labels)
        for i in zmask:
            outputs.update({f"{i}::Zernike_{n}_{m}": v for (n, m), v in mask_out.items()})
            handled.add(i)
        for c, (i, _) in enumerate(zimg):
            outputs.update({f"{i}::RadialZernike_{n}_{m}": v for (n, m), v in img_outs[c].items()})
            handled.add(i)
    for idx, entry in enumerate(plan_sig):
        if idx in handled:
            continue
        for name, v in _entry_values(entry, labels, imgs, max_labels).items():
            outputs[f"{idx}::{name}"] = v
    names = sorted(outputs)
    if not names:
        # an empty tree is legal (a pair-less coloc tree for single-channel
        # extraction): a 0-row feature block
        return [], torch.zeros((0, labels.shape[0], max_labels), device=labels.device)
    with span("features.concat", device=labels.device):
        return names, torch.stack([outputs[n] for n in names])


class FusedTreeResult:
    """Lazy stand-in for the reference's ``(tileid_instructions, results)``
    pair: holds one tree's ``(n_names, F, L)`` block plus the plan lookup,
    and builds the per-(tile, label, instruction) rows only when unpacked.
    :meth:`columns` gives the wide table's columns as numpy arrays;
    :meth:`to_table` wraps them in a pyarrow table."""

    def __init__(self, instructions, inst_lookup, names, arr, n_per_tile):
        self.instructions = tuple(instructions)
        self.inst_lookup = inst_lookup
        self.names = list(names)
        self.arr = np.asarray(arr)  # (n_names, F, max_labels)
        self.n_per_tile = [int(n) for n in n_per_tile]
        self._rows = None

    # -- (tileid_instructions, results) 2-tuple protocol ------------------
    def _materialize(self):
        if self._rows is not None:
            return self._rows
        F = len(self.n_per_tile)
        ind_masks = [(f, l) for f in range(F) for l in range(1, self.n_per_tile[f] + 1)]
        tileid_instructions = tuple(product(ind_masks, self.instructions))
        dict_views: dict = {}
        for i, name in enumerate(self.names):
            idx_str, feat = name.split("::", 1)
            dict_views.setdefault(int(idx_str), {})[feat] = self.arr[i]
        results = []
        for (tile_i, label), inst in tileid_instructions:
            mode, entry_idx, metric = self.inst_lookup[inst]
            if mode == "scalar":
                results.append(float(dict_views[entry_idx][metric][tile_i, label - 1]))
            else:
                results.append({k: np.asarray([v[tile_i, label - 1]])
                                for k, v in dict_views[entry_idx].items()})
        self._rows = (tileid_instructions, results)
        return self._rows

    def __len__(self):
        return 2

    def __iter__(self):
        return iter(self._materialize())

    def __getitem__(self, i):
        return self._materialize()[i]

    @property
    def tileid_instructions(self):
        return self._materialize()[0]

    def columns(self) -> dict:
        """The wide table's columns, in order: ``tile``, ``label`` (int64),
        then every feature column (float64) sorted by name, as the
        reference's ``format_extraction`` names them."""
        F = len(self.n_per_tile)
        total = sum(self.n_per_tile)
        if total == 0 or not self.instructions:
            return {"tile": np.zeros(0, np.int64), "label": np.zeros(0, np.int64)}
        tiles = np.repeat(np.arange(F), self.n_per_tile)
        labels = np.concatenate([np.arange(1, n + 1) for n in self.n_per_tile]).astype(np.int64)
        name_row = {n: i for i, n in enumerate(self.names)}
        entry_feats: dict[int, list[str]] = {}
        for n in self.names:
            idx_str, feat = n.split("::", 1)
            entry_feats.setdefault(int(idx_str), []).append(feat)
        gathered = self.arr[:, tiles, labels - 1].astype(np.float64)
        cols: dict = {}
        for inst in self.instructions:
            mode, entry_idx, metric = self.inst_lookup[inst]
            branch = "/".join(str(x) for x in inst)
            last = str(inst[-1])
            if mode == "scalar":
                cols[f"{branch}/{last}"] = gathered[name_row[f"{entry_idx}::{metric}"]]
            else:
                for feat in entry_feats[entry_idx]:
                    cname = branch if feat == last else f"{branch}/{feat}"
                    cols[cname] = gathered[name_row[f"{entry_idx}::{feat}"]]
        out = {"tile": tiles.astype(np.int64), "label": labels}
        for cname in sorted(cols):
            out[cname] = cols[cname]
        return out

    def to_table(self):
        """The wide pyarrow table of :meth:`columns` (pyarrow is imported
        here only: the GPU hosts of the port need not have it)."""
        import pyarrow as pa

        cols = self.columns()
        if not len(cols["tile"]):
            return pa.Table.from_pydict({"tile": [], "label": []})
        return pa.Table.from_pydict(cols)


# ---------------------------------------------------------------------------
# The interpreted path (one extract step, one timepoint)
# ---------------------------------------------------------------------------


def _reduce_z(pixels: np.ndarray, method) -> np.ndarray:
    """Reduce the leading (Z) axis on the host, as the reference's
    interpreted path does."""
    if method is None or method == "None":
        return pixels
    m = str(method)
    if m == "max":
        return pixels.max(axis=0)
    if m == "min":
        return pixels.min(axis=0)
    if m == "mean":
        return pixels.mean(axis=0)
    if m == "median":
        return np.median(pixels, axis=0)
    if m in ("add", "sum"):
        return pixels.sum(axis=0)
    raise KeyError(f"Unknown z-reduction {method!r}")


# the z-reductions and channel combinations a tree may name (the reference's set)
REDUCTION_FUNS = {"max", "min", "mean", "median", "add", "div", "None", None}


def _max_labels_bucket(n: int) -> int:
    b = 8
    while b < n:
        b *= 2
    return b


def _slot_images(pixels: np.ndarray, slot_of: dict, device, tiles=None) -> list:
    """Each image slot (channel, z-reduction) of the (F, C, Z, Y, X) tile
    stack, z-reduced on the host, on ``device``; ``tiles`` picks (and
    repeats) tiles on the device."""
    imgs = [None] * len(slot_of)
    for (ch, red_z), si in slot_of.items():
        stack = np.stack([_reduce_z(np.asarray(pixels[f, ch], np.float32), red_z)
                          for f in range(pixels.shape[0])])
        im = torch.from_numpy(np.ascontiguousarray(stack)).to(device)
        imgs[si] = im if tiles is None else im.index_select(0, tiles)
    return imgs


def _tree_result(tree: dict, labels: torch.Tensor, pixels: np.ndarray, cp_measure_kwargs,
                 device, tiles=None):
    """The tree over (V, Y, X) device labels -> a :class:`FusedTreeResult`,
    or ``None`` when there is no object or no instruction."""
    instructions = kv(flatten(tree))
    n_per_tile = labels.reshape(labels.shape[0], -1).amax(dim=1).tolist() \
        if labels.shape[0] else []
    if not any(n_per_tile) or not instructions:
        return None
    max_labels = _max_labels_bucket(max(n_per_tile + [1]))
    entries, slot_of, inst_lookup = compile_plan(instructions, cp_measure_kwargs or {})
    imgs = _slot_images(pixels, slot_of, device, tiles)
    with torch.no_grad():
        names, arr = tree_collect(entries, labels, imgs, max_labels)
    return FusedTreeResult(instructions, inst_lookup, names, arr.cpu().numpy(), n_per_tile)


def _tile_stack(pixels) -> np.ndarray:
    pixels = np.asarray(pixels)
    return pixels[0] if pixels.ndim == 6 else pixels  # a leading T of size 1


def process_tree_masks(tree: dict, masks, pixels, ncores=None,
                       cp_measure_kwargs: dict | None = None, progress_bar: bool = False,
                       device=None, **kwargs):
    """Compute every (object x instruction) value for one timepoint.

    ``masks`` is a per-tile list of 2-D label maps, ``pixels`` the tile
    stack ``(F, C, Z, Y, X)``; the tree runs on ``device`` (``cuda`` by
    default). ``ncores`` is accepted for API compatibility and ignored.
    Returns a lazy :class:`FusedTreeResult` (the reference's
    ``(tileid_instructions, results)``).
    """
    from aliby_tpu_torch.device import resolve_device

    del ncores, progress_bar
    device = resolve_device(device)
    if isinstance(masks, np.ndarray) and masks.ndim == 3:
        labels = masks.astype(np.int32)
    else:
        labels = np.stack([np.asarray(m) for m in masks]).astype(np.int32)
    out = _tree_result(tree, torch.from_numpy(labels).to(device), _tile_stack(pixels),
                       cp_measure_kwargs, device)
    return ((), []) if out is None else out


class OverlapTreeResult:
    """The overlap path's ``(tileid_instructions, results,
    inverse_mappings)`` triple, lazily: ``virtual`` holds the tree over the
    virtual tiles, ``virtual_ids[v]`` the (tile, layer) of virtual tile v
    and ``inverse_mappings[(tile, layer)][k]`` the original label of its
    sequential label k. Instruction ids are ``((tile, layer, label),
    instruction)``; :meth:`columns` gives the wide table's columns."""

    def __init__(self, virtual, virtual_ids, inverse_mappings):
        self.virtual = virtual  # FusedTreeResult or None
        self.virtual_ids = list(virtual_ids)
        self.inverse_mappings = inverse_mappings
        self._rows = None

    def _materialize(self):
        if self._rows is None:
            if self.virtual is None:
                self._rows = ((), [], self.inverse_mappings)
            else:
                v_instr, results = self.virtual
                ids = tuple(((*self.virtual_ids[v], label), inst) for (v, label), inst in v_instr)
                self._rows = (ids, results, self.inverse_mappings)
        return self._rows

    def __len__(self):
        return 3

    def __iter__(self):
        return iter(self._materialize())

    def __getitem__(self, i):
        return self._materialize()[i]

    def columns(self) -> dict:
        """``metadata_tile``, ``metadata_label`` (the original labels,
        int64), then the metric columns (float64) sorted by name. A (tile,
        label) that several layers hold takes each column from its last
        layer, as the reference's row dict does."""
        if self.virtual is None:
            return {"metadata_tile": np.zeros(0, np.int64),
                    "metadata_label": np.zeros(0, np.int64)}
        cols = self.virtual.columns()
        if not len(cols["tile"]):
            return {"metadata_tile": np.zeros(0, np.int64),
                    "metadata_label": np.zeros(0, np.int64)}
        tiles = np.asarray([self.virtual_ids[v][0] for v in cols["tile"]], np.int64)
        orig = np.asarray([int(self.inverse_mappings[self.virtual_ids[v]][lab])
                           for v, lab in zip(cols["tile"], cols["label"])], np.int64)
        row_of: dict = {}
        for i, key in enumerate(zip(tiles.tolist(), orig.tolist())):
            row_of[key] = i  # first position, last value
        pick = np.asarray(list(row_of.values()), np.int64)
        keys = np.asarray(list(row_of.keys()), np.int64).reshape(-1, 2)
        out = {"metadata_tile": keys[:, 0], "metadata_label": keys[:, 1]}
        for name, col in cols.items():
            if name not in ("tile", "label"):
                out[name] = col[pick]
        return out


def process_tree_masks_overlap(tree: dict, masks, pixels, ncores=None,
                               cp_measure_kwargs: dict | None = None,
                               progress_bar: bool = False, device=None, **kwargs):
    """BABY-style extraction over stacked, possibly overlapping masks.

    ``masks`` is a per-tile list of (n_layers, Y, X) label stacks (BABY's
    layered output; a 2-D map is one layer). Each (tile, layer) is
    relabelled sequentially (one batched call on ``device``) and is a
    virtual tile of the same core as :func:`process_tree_masks`; the
    inverse label maps ride along (reference ``extract.py:456-517``).
    Returns an :class:`OverlapTreeResult`.
    """
    from aliby_tpu_torch.device import resolve_device
    from aliby_tpu_torch.ops.labels import relabel_sequential_batched

    del ncores, progress_bar
    device = resolve_device(device)
    pixels = _tile_stack(pixels)
    layers, virtual_ids = [], []
    for t, layered in enumerate(masks):
        layered = np.asarray(layered)
        if layered.ndim == 2:
            layered = layered[None]
        for s in range(layered.shape[0]):
            layers.append(layered[s].astype(np.int32))
            virtual_ids.append((t, s))
    if not layers:
        return OverlapTreeResult(None, [], {})
    stack = torch.from_numpy(np.stack(layers)).to(device)
    bucket = _max_labels_bucket(max(int(stack.max()), 1))
    relab, fwd = relabel_sequential_batched(stack, bucket)
    fwd = fwd.cpu().numpy()
    inverse = {vid: fwd[v] for v, vid in enumerate(virtual_ids)}
    tiles = torch.as_tensor([t for t, _ in virtual_ids], dtype=torch.int64, device=device)
    virtual = _tree_result(tree, relab, pixels, cp_measure_kwargs, device, tiles)
    return OverlapTreeResult(virtual, virtual_ids, inverse)


# ---------------------------------------------------------------------------
# Formatting (column contract of the reference's extract.py:520-599)
# ---------------------------------------------------------------------------


def extraction_columns(instructions_result) -> dict:
    """The wide table of one extraction as ordered numpy columns: ``tile``,
    ``label`` (int64), then the metric columns (float64) sorted by name. A
    value that a row lacks is masked (``numpy.ma``), as the reference's
    table holds a null there."""
    if isinstance(instructions_result, FusedTreeResult):
        return instructions_result.columns()
    if isinstance(instructions_result, np.ndarray):
        return _embedding_columns(instructions_result)
    rows: dict = {}
    metric_names: set = set()
    for inst, metrics in zip(*instructions_result, strict=True):
        key = (inst[0][0], inst[0][-1])
        branch = "/".join(str(x) for x in inst[1])
        if isinstance(metrics, (int, float, np.integer, np.floating)):
            name = f"{branch}/{inst[1][-1]}"
            rows.setdefault(key, {})[name] = float(metrics)
            metric_names.add(name)
        elif isinstance(metrics, dict):
            for k, values in metrics.items():
                # a family key that repeats the metric name collapses (the
                # coloc families): "(0, 3)/None/max/pearson"
                name = branch if k == str(inst[1][-1]) else f"{branch}/{k}"
                for value in np.asarray(values).reshape(-1):
                    rows.setdefault(key, {})[name] = float(value)
                    metric_names.add(name)
        else:
            raise TypeError(f"the metrics are in an invalid value: {type(metrics)}. "
                            "Valid values are int/float or dict.")
    cols = {"tile": np.asarray([k[0] for k in rows], np.int64),
            "label": np.asarray([k[1] for k in rows], np.int64)}
    for n in sorted(metric_names):
        vals = [r.get(n) for r in rows.values()]
        missing = np.asarray([v is None for v in vals], bool)
        col = np.asarray([np.nan if v is None else v for v in vals], np.float64)
        cols[n] = np.ma.MaskedArray(col, mask=missing) if missing.any() else col
    return cols


def _embedding_columns(emb: np.ndarray) -> dict:
    """An embedder's (F, dim) output: row r is ``tile`` r, ``label`` 0, and
    ``X_<c>`` holds dimension c; the columns sorted by name, as the
    reference's table sorts them (``X_0, X_1, X_10, ...``)."""
    emb = np.asarray(emb)
    n, dim = emb.shape
    cols = {"tile": np.arange(n, dtype=np.int64), "label": np.zeros(n, np.int64)}
    for name in (sorted(f"X_{c}" for c in range(dim)) if n else ()):
        cols[name] = emb[:, int(name[2:])].astype(np.float64)
    return cols


def format_extraction(instructions_result):
    """The wide ``pyarrow.Table`` of :func:`extraction_columns`."""
    import pyarrow as pa

    cols = extraction_columns(instructions_result)
    if not len(cols["tile"]):
        return pa.Table.from_pydict({"tile": [], "label": []})
    return pa.Table.from_pydict(cols)


def extraction_columns_overlap(result: OverlapTreeResult) -> dict:
    """The overlap path's wide table as ordered numpy columns
    (``metadata_tile``, ``metadata_label`` with the original labels, then
    the metric columns sorted by name; reference ``extract.py:602-683``)."""
    return result.columns()


def format_extraction_overlap(result: OverlapTreeResult):
    """The wide ``pyarrow.Table`` of :func:`extraction_columns_overlap`."""
    import pyarrow as pa

    return pa.Table.from_pydict(result.columns())
