"""Device meshes and sharding helpers (counterpart of
``aliby_tpu/parallel/mesh.py``).

The JAX package's mesh is a ``jax.sharding.Mesh`` over two axes:

- ``dp``: data parallel over positions, tiles or the training batch;
- ``sp``: spatial partitioning of image rows (the U-Net's convolutions
  exchange halo rows across it).

Here a :class:`Mesh` is a ``(dp, sp)`` array of ``torch.device`` with the
same shape and defaults. One process drives a mesh of several devices from
threads (:func:`~aliby_tpu_torch.parallel.pipeline_mesh.run_positions_mesh`),
or each process of a ``torch.distributed`` group holds one place of it
(:meth:`Mesh.from_process_group`, the sharded train step). A mesh may name
one card more than once, or the CPU, so that one card or the CPU rehearses
dp > 1. A partition spec is a tuple of axis names or ``None`` per array
axis, as ``jax.sharding.PartitionSpec`` is written.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from aliby_tpu_torch.device import resolve_device

AXES = ("dp", "sp")


def _split(dp: int | None, sp: int | None, n: int) -> tuple[int, int]:
    """The reference's defaults: every device on dp and sp 1; a given axis
    takes its share of ``n``; ``dp * sp`` must be ``n``."""
    if dp is None and sp is None:
        dp, sp = n, 1
    elif dp is None:
        dp = n // sp
    elif sp is None:
        sp = n // dp
    if dp * sp != n:
        raise ValueError(f"dp({dp}) * sp({sp}) != n_devices({n})")
    return dp, sp


class Mesh:
    """A ``(dp, sp)`` grid of devices. In one process of a
    ``torch.distributed`` group (:meth:`from_process_group`) it also knows
    the process's ``rank`` (row-major over ``(dp, sp)``) and its ``sp``
    group; otherwise both are None."""

    def __init__(self, devices: np.ndarray, rank: int | None = None, sp_group=None):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != 2 or devices.size == 0:
            raise ValueError(f"a mesh is a non-empty (dp, sp) grid, got shape {devices.shape}")
        self.devices = devices
        self.rank = rank
        self.sp_group = sp_group

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(AXES, self.devices.shape))

    @property
    def axis_names(self) -> tuple[str, str]:
        return AXES

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def dp_devices(self) -> list[torch.device]:
        """The first device of each sp row: where a dp shard runs when its
        work is not split over sp."""
        return list(self.devices[:, 0])

    def coords(self, rank: int | None = None) -> tuple[int, int]:
        """``(dp index, sp index)`` of ``rank`` (default: this process's)."""
        rank = self.rank if rank is None else rank
        if rank is None:
            raise ValueError("this mesh belongs to no process group: pass a rank")
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        return divmod(rank, self.shape["sp"])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"

    @classmethod
    def from_process_group(cls, dp: int | None = None, sp: int | None = None,
                           device: str | torch.device | None = None) -> "Mesh":
        """This process's place in a ``(dp, sp)`` mesh over the initialised
        default ``torch.distributed`` group (row-major: rank ``d * sp + s``),
        with ``device`` its own (default ``cuda:<rank % cards>``). Every
        rank must call it with the same ``dp`` and ``sp``: it gathers the
        ranks' devices and makes one group per sp row, in row order.

        NCCL refuses two ranks on one card, so a group whose backend is
        ``nccl`` and whose ranks repeat a card raises; such a rehearsal
        passes ``backend="gloo"`` to ``init_process_group`` itself."""
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("Mesh.from_process_group needs torch.distributed initialised")
        world, rank = dist.get_world_size(), dist.get_rank()
        dp, sp = _split(dp, sp, world)
        if device is None:
            device = f"cuda:{rank % max(1, torch.cuda.device_count())}"
        device = resolve_device(device)
        if device.type == "cuda":
            if device.index is None:
                device = torch.device("cuda", torch.cuda.current_device())
            torch.cuda.set_device(device)
        names: list = [None] * world
        dist.all_gather_object(names, str(device))
        if dist.get_backend() == "nccl" and len(set(names)) < world:
            raise ValueError(f"NCCL refuses two ranks on one card ({names}); initialise the "
                             "group with backend='gloo' to rehearse on one card")
        own = None
        for d in range(dp):
            group = dist.new_group([d * sp + s for s in range(sp)])
            if d == rank // sp:
                own = group
        devices = np.empty((dp, sp), dtype=object)
        for r, name in enumerate(names):
            devices[divmod(r, sp)] = torch.device(name)
        return cls(devices, rank=rank, sp_group=own)


def make_mesh(n_devices: int | None = None, dp: int | None = None, sp: int | None = None,
              devices: Sequence | None = None) -> Mesh:
    """Mesh over (dp, sp). Defaults: all devices on dp, sp = 1.

    ``devices`` defaults to every visible card (``cuda:0`` ...); asking for
    it without a card raises (nothing falls back to the CPU). It may repeat
    a card or list the CPU, e.g. ``["cuda:0"] * 2`` or ``["cpu"] * 2``."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            resolve_device("cuda")  # raises: no card
        devices = [torch.device("cuda", i) for i in range(count)]
    else:
        devices = [resolve_device(d) for d in devices]
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"n_devices({n}) > the {len(devices)} devices given")
    dp, sp = _split(dp, sp, n)
    arr = np.empty((dp, sp), dtype=object)
    for i, d in enumerate(devices[:n]):
        arr[divmod(i, sp)] = d
    return Mesh(arr)


def batch_sharding(mesh: Mesh) -> tuple:
    """Shard the leading (position/tile) axis over dp, rows over sp."""
    return ("dp", "sp")


def replicated(mesh: Mesh) -> tuple:
    return ()


def sp_rows(height: int, sp: int, unit: int = 1) -> tuple[int, ...]:
    """Rows of each of ``sp`` blocks of ``height`` rows, each a multiple of
    ``unit`` (the U-Net pools ``len(feats) - 1`` times, so its blocks start
    on multiples of ``2 ** (len(feats) - 1)``): as even as the unit allows,
    the first blocks one unit larger. 1080 rows over 2 in units of 8:
    (544, 536)."""
    if sp < 1 or unit < 1:
        raise ValueError(f"sp and unit must be positive, got {sp}, {unit}")
    units, rest = divmod(height, unit)
    if rest or units < sp:
        raise ValueError(
            f"{height} rows cannot be split over sp={sp}: every block must hold a positive "
            f"multiple of {unit} rows (the U-Net's 2^(levels-1)), so the rows must be a "
            f"multiple of {unit} and at least {sp * unit}")
    q, r = divmod(units, sp)
    return tuple((q + (i < r)) * unit for i in range(sp))


def even_split(n: int, parts: int) -> list[int]:
    """``n`` split into ``parts`` sizes as even as they go, the first ones
    one larger."""
    q, r = divmod(n, parts)
    return [q + (i < r) for i in range(parts)]


def block_slices(shape: Sequence[int], spec: Sequence, mesh: Mesh, rank: int,
                 unit: int = 1) -> tuple[slice, ...]:
    """The index of ``rank``'s block of an array of ``shape`` under
    ``spec``: an axis named ``dp`` split as evenly as it goes (the first
    blocks one larger), one named ``sp`` by :func:`sp_rows` in ``unit``s,
    any other axis whole."""
    d, s = mesh.coords(rank)
    index = []
    for axis, size in enumerate(shape):
        name = spec[axis] if axis < len(spec) else None
        if name is None:
            index.append(slice(None))
            continue
        if name == "dp":
            sizes, at = even_split(size, mesh.shape["dp"]), d
        elif name == "sp":
            sizes, at = sp_rows(size, mesh.shape["sp"], unit), s
        else:
            raise ValueError(f"unknown mesh axis {name!r} (axes: {AXES})")
        start = sum(sizes[:at])
        index.append(slice(start, start + sizes[at]))
    return tuple(index)


def shard_batch(mesh: Mesh, tree, rank: int | None = None, spec=("dp",), unit: int = 1):
    """``rank``'s block (default: this process's) of every array of a batch
    (a dict, list or tuple of tensors or numpy arrays): the leading axis over
    dp, as the reference's ``shard_batch`` puts it. ``spec`` is one
    partition spec for every leaf, or a dict of specs by key; ``sp`` axes
    split by :func:`sp_rows` in ``unit``s. The blocks are views."""
    rank = mesh.rank if rank is None else rank

    def put(x, leaf_spec):
        return x[block_slices(x.shape, leaf_spec, mesh, rank, unit)] if x.ndim else x

    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v, rank, spec[k] if isinstance(spec, dict) else spec, unit)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(mesh, v, rank, spec, unit) for v in tree)
    return put(tree, spec)
