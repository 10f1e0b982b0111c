"""The fused per-timepoint step (counterpart of ``aliby_tpu/engine/fused.py``):
segmentation of every object plus every feature tree, batched over the tile
axis F, with one upload of the pixel block and one readback of labels and
feature values.

Usage::

    step = compile_fused_step([
        FusedObject(engine, main_ch, second_ch, [(mono_tree, cpkw), ...]),
        ...
    ])
    out = step(pixels)   # {"labels": [(F, Y, X) per object],
                         #  "features": [[(names, (n, F, L) array), ...] per object]}

:func:`results_from_fused` turns one tree's output back into the
reference's ``(instructions, results)`` structure.

The reference compiles one XLA program per label width and, when the
realised label count overflows the narrow width (or uint8), reruns the
whole step wider and stays wide (sticky). PyTorch runs eagerly, so here the
step reads the realised maximum label right after segmentation and applies
the same sticky transition before the feature trees run: the outputs,
shapes and state over a sequence of calls are the reference's, without the
discarded narrow pass.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from aliby_tpu_torch.extract.extract import (
    FusedTreeResult,
    compile_plan,
    flatten,
    kv,
    reduce_z_traced,
    tree_collect,
)


@dataclass
class FusedObject:
    engine: object  # CellposeTorch (or anything with ._segment_all(images) and .device)
    channel: int
    second_channel: int | None
    trees: Sequence[tuple[dict, dict | None]]  # [(tree, cp_measure_kwargs)]


def _pack_labels(labels: torch.Tensor, u8: bool) -> torch.Tensor:
    """uint8, or uint16 carried in int16 bits (read back as uint16)."""
    if u8:
        return labels.to(torch.uint8)
    return (labels & 0xFFFF).to(torch.int16)


def compile_fused_step(objects: Sequence[FusedObject], max_labels: int = 256,
                       out_labels_cap: int = 64):
    """Build the step for ``objects``; it runs on their engines' device.

    ``out_labels_cap`` bounds the label axis of the feature trees (their
    compute width and the readback); segmentation always labels at its own
    ``max_labels``. A step whose realised maximum label exceeds the cap
    widens to ``max_labels`` and stays there; one above 255 reads labels
    back as uint16 from then on (the reference's sticky rule).
    """
    if not (0 < max_labels <= 65535):
        # the widest readback dtype is uint16; labels above 65535 would wrap
        raise ValueError(f"max_labels must be in [1, 65535], got {max_labels}")
    if not objects:
        raise ValueError("compile_fused_step needs at least one object")
    device = torch.device(objects[0].engine.device)
    if any(torch.device(o.engine.device) != device for o in objects):
        raise ValueError("every object's engine must run on one device")
    plans = []
    for obj in objects:
        obj_plans = []
        for tree, cpkw in obj.trees:
            instructions = kv(flatten(tree))
            entries, slot_of, inst_lookup = compile_plan(instructions, cpkw or {})
            obj_plans.append((instructions, entries, slot_of, inst_lookup))
        plans.append(obj_plans)

    # objects sharing one engine segment as one concatenated batch
    seg_groups: list[list[int]] = []
    group_of: dict[int, int] = {}
    for oi, obj in enumerate(objects):
        key = id(obj.engine)
        if key in group_of:
            seg_groups[group_of[key]].append(oi)
        else:
            group_of[key] = len(seg_groups)
            seg_groups.append([oi])

    # trees with identical plans run once over the objects' concatenated labels
    tree_groups: dict[tuple, list[tuple[int, int]]] = {}
    for oi, obj_plans in enumerate(plans):
        for ti, (_insts, entries, slot_of, _lookup) in enumerate(obj_plans):
            key = (tuple(entries), tuple(sorted(slot_of.items(), key=lambda item: item[1])))
            tree_groups.setdefault(key, []).append((oi, ti))

    cap0 = min(max(1, out_labels_cap), max_labels)
    state = {"cap": cap0, "u8": True}

    def segment(pixels: torch.Tensor) -> list[torch.Tensor]:
        """(F, C, Z, Y, X) -> per object (F, Y, X) int32 labels."""
        F = pixels.shape[0]

        def obj_images(obj):
            main = pixels[:, obj.channel].amax(dim=1)
            if obj.second_channel is not None:
                sec = pixels[:, obj.second_channel].amax(dim=1)
            else:
                sec = torch.zeros_like(main)
            return torch.stack([main, sec], dim=1)  # (F, 2, Y, X)

        all_labels: list = [None] * len(objects)
        for group in seg_groups:
            images = torch.cat([obj_images(objects[oi]) for oi in group])
            # the U-Net needs H, W divisible by 8 (3 pooling levels): reflect-pad, crop
            H, W = images.shape[-2:]
            ph, pw = (-H) % 8, (-W) % 8
            if ph or pw:
                images = torch.nn.functional.pad(images, (0, pw, 0, ph), mode="reflect")
            labels = objects[group[0]].engine._segment_all(images)[:, :H, :W]
            for k, oi in enumerate(group):
                all_labels[oi] = labels[k * F:(k + 1) * F].to(torch.int32)
        return all_labels

    def features(pixels: torch.Tensor, all_labels, cap: int):
        F = pixels.shape[0]
        slot_cache: dict = {}

        def slot_img(ch, red_z):
            if (ch, red_z) not in slot_cache:
                slot_cache[(ch, red_z)] = reduce_z_traced(pixels[:, ch], red_z, dim=1)
            return slot_cache[(ch, red_z)]

        all_feats = [[None] * len(obj.trees) for obj in objects]
        for members in tree_groups.values():
            oi0, ti0 = members[0]
            _insts, entries, slot_of, _lookup = plans[oi0][ti0]
            imgs = [None] * len(slot_of)
            for (ch, red_z), si in slot_of.items():
                imgs[si] = slot_img(ch, red_z)
            k = len(members)
            labels_cat = torch.cat([all_labels[oi] for oi, _ in members])
            imgs_cat = [torch.cat([im] * k) if k > 1 else im for im in imgs]
            names, arr = tree_collect(entries, labels_cat, imgs_cat, cap)
            for j, (oi, ti) in enumerate(members):
                all_feats[oi][ti] = (names, arr[:, j * F:(j + 1) * F])
        return all_feats

    def segment_phase(pixels):
        """The step's first half: the pixel block on the device and its
        labels. Returns ``(seg, lmax)``: what :func:`features_phase` takes,
        and the largest realised label (read back: the sticky width needs
        it before the trees run)."""
        if not isinstance(pixels, torch.Tensor):
            pixels = torch.from_numpy(np.ascontiguousarray(np.asarray(pixels, np.float32)))
        if pixels.dim() == 6:
            pixels = pixels[0]
        pixels = pixels.to(device=device, dtype=torch.float32)
        with torch.no_grad():
            all_labels = segment(pixels)
            labels_pack = torch.stack(all_labels)
            return (pixels, all_labels, labels_pack), int(labels_pack.max())

    def features_phase(seg, cap: int, u8: bool):
        """The step's second half at tree width ``cap``: a handle whose
        tensors :func:`collect` reads back."""
        pixels, all_labels, labels_pack = seg
        with torch.no_grad():
            feats = features(pixels, all_labels, cap)
            flat = [a for per_obj in feats for _, a in per_obj]
            feats_pack = (torch.cat(flat) if flat
                          else torch.zeros(0, pixels.shape[0], cap, device=device))
            names = [[n for n, _ in per_obj] for per_obj in feats]
            return _pack_labels(labels_pack, u8), feats_pack, names

    def dispatch(pixels):
        """Run the step on the device; returns a handle whose tensors
        :func:`collect` reads back."""
        seg, lmax = segment_phase(pixels)
        widen(state, lmax, max_labels)
        return features_phase(seg, state["cap"], state["u8"])

    def collect(handle):
        """Read back one dispatch's results and unpack them per object."""
        labels_pack, feats_pack, names = handle
        labels = labels_pack.cpu().numpy()
        if labels.dtype == np.int16:
            labels = labels.view(np.uint16)
        labels = labels.astype(np.int32)
        big = feats_pack.cpu().numpy()
        out_feats, off = [], 0
        for per_obj in names:
            obj_out = []
            for n in per_obj:
                obj_out.append((n, big[off:off + len(n)]))
                off += len(n)
            out_feats.append(obj_out)
        return {"labels": list(labels), "features": out_feats}

    def device_labels(handle) -> torch.Tensor:
        """A handle's labels on the device: (n_objects, F, Y, X) int32."""
        labels_pack = handle[0]
        labels = labels_pack.to(torch.int32)
        return labels if labels_pack.dtype == torch.uint8 else labels & 0xFFFF

    def run(pixels):
        return collect(dispatch(pixels))

    run.plans = plans
    run.dispatch = dispatch
    run.collect = collect
    run.device_labels = device_labels
    run.segment_phase = segment_phase
    run.features_phase = features_phase
    run.state = state
    run.initial_state = dict(state)
    run.device = device
    run.max_labels = max_labels
    return run


def widen(state: dict, lmax: int, max_labels: int) -> None:
    """The sticky transition: realised objects past the tree width widen it
    to ``max_labels`` for good; past 255 the labels are read back as uint16
    from then on."""
    if lmax > state["cap"]:
        state["cap"] = max_labels
    state["u8"] = state["u8"] and lmax <= 255


class ShardedStep:
    """One fused step over dp shards, each a fused step
    (:func:`compile_fused_step`) on its own device; a device may appear
    more than once (two shards on one card, each on its own stream).

    ``dispatch(blocks)`` takes one pixel block a shard and runs
    segmentation on every shard, each in its own host thread with its
    device current and on its own stream; then it widens the one shared
    sticky ``state`` once by the largest label over all shards, and runs
    the feature trees of every shard at that common width. This is the
    reference's rule on the global batch: a state per shard would let the
    shards disagree on the width and widen at different timepoints.
    ``collect(handles)`` reads the shards back and concatenates them in
    shard order. A single shard runs on the calling thread and its current
    stream, exactly as :func:`compile_fused_step`'s ``dispatch``. The
    sticky ``state`` is the sharded step's own and starts as the first
    shard's step started (its ``initial_state``).

    A block given as host memory is copied to its device on the shard's
    stream; a block already on the card is marked as used by that stream
    (``record_stream``), so the caller may drop it at once.

    ``shard_launches[i]`` counts the kernel launches that shard ``i``'s
    thread made, by wrapper name (:func:`aliby_tpu_torch.kernels._build.
    tally`)."""

    def __init__(self, runs: Sequence):
        if not runs:
            raise ValueError("a sharded step needs at least one shard")
        if any(run.max_labels != runs[0].max_labels for run in runs):
            raise ValueError("every shard must label at one max_labels")
        self.runs = list(runs)
        self.devices = [run.device for run in runs]
        self.max_labels = runs[0].max_labels
        self.state = dict(runs[0].initial_state)
        multi = len(runs) > 1
        self.streams = [torch.cuda.Stream(d) if multi and d.type == "cuda" else None
                        for d in self.devices]
        self.shard_launches: list[dict[str, int]] = [{} for _ in runs]
        self._pool = None
        if multi:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=len(runs),
                                            thread_name_prefix="fused-shard")

    def _in_shard(self, i: int, wait, fn, args):
        from contextlib import ExitStack

        from aliby_tpu_torch.kernels import _build

        with ExitStack() as stack:
            if self.devices[i].type == "cuda":
                stack.enter_context(torch.cuda.device(self.devices[i]))
                if self.streams[i] is not None:
                    if wait is not None:
                        self.streams[i].wait_stream(wait)
                    stack.enter_context(torch.cuda.stream(self.streams[i]))
            counts = stack.enter_context(_build.tally())
            try:
                return fn(*args)
            finally:
                for name, n in counts.items():
                    self.shard_launches[i][name] = self.shard_launches[i].get(name, 0) + n

    def map(self, fn, per_shard: Sequence, wait: bool = False, shards=None) -> list:
        """``fn(i, *per_shard[k])`` for each shard ``i`` of ``shards``
        (default: all, ``per_shard`` one argument tuple a shard), each in
        its shard's thread with its device current and on its stream; the
        results in order. ``wait`` first makes each shard's stream wait for
        the calling thread's current stream on that device (its inputs).
        Work on a shard's tensors goes through here, so that it stays on the
        shard's stream."""
        shards = list(range(len(self.runs))) if shards is None else list(shards)
        calls = []
        for i, args in zip(shards, per_shard):
            caller = (torch.cuda.current_stream(self.devices[i])
                      if wait and self.streams[i] is not None else None)
            calls.append((i, caller, fn, (i, *args)))
        if self._pool is None or len(calls) == 1:
            return [self._in_shard(*c) for c in calls]
        futures = [self._pool.submit(self._in_shard, *c) for c in calls]
        return [f.result() for f in futures]

    def dispatch(self, blocks: Sequence, shards=None) -> list:
        """One pixel block a shard (of ``shards``, default all) -> one
        handle a shard."""
        def segment(i, blk):
            if isinstance(blk, torch.Tensor) and blk.is_cuda and self.streams[i] is not None:
                blk.record_stream(self.streams[i])
            return self.runs[i].segment_phase(blk)

        segs = self.map(segment, [(b,) for b in blocks], wait=True, shards=shards)
        widen(self.state, max(lmax for _, lmax in segs), self.max_labels)
        cap, u8 = self.state["cap"], self.state["u8"]
        return self.map(lambda i, seg: self.runs[i].features_phase(seg, cap, u8),
                        [(seg,) for seg, _ in segs], shards=shards)

    def collect_shards(self, handles: Sequence, shards=None) -> list[dict]:
        """Each shard's results, as :func:`compile_fused_step`'s ``collect``."""
        return self.map(lambda i, h: self.runs[i].collect(h), [(h,) for h in handles],
                        shards=shards)

    def collect(self, handles: Sequence, shards=None) -> dict:
        """Every shard's results concatenated in shard order."""
        return concat_outputs(self.collect_shards(handles, shards))

    def __call__(self, blocks: Sequence) -> dict:
        return self.collect(self.dispatch(blocks))

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


def concat_outputs(outs: Sequence[dict]) -> dict:
    """Collected outputs of several calls, their rows concatenated in order
    (the feature blocks share one tree width)."""
    if len(outs) == 1:
        return outs[0]
    labels = [np.concatenate(parts) for parts in zip(*(o["labels"] for o in outs))]
    features = []
    for per_obj in zip(*(o["features"] for o in outs)):
        features.append([(trees[0][0], np.concatenate([arr for _, arr in trees], axis=1))
                         for trees in zip(*per_obj)])
    return {"labels": list(labels), "features": features}


def results_from_fused(plan, names: list[str], arr: np.ndarray, labels: np.ndarray):
    """One tree's fused output as a lazy :class:`FusedTreeResult` (the
    reference's ``(tileid_instructions, results)`` structure)."""
    instructions, _entries, _slot_of, inst_lookup = plan
    labels = np.asarray(labels)
    n_per_tile = [int(labels[f].max()) for f in range(labels.shape[0])]
    return FusedTreeResult(instructions, inst_lookup, names, np.asarray(arr), n_per_tile)
