"""Spatial partitioning of the U-Net over the ``sp`` axis of a mesh: each
rank of an sp group holds a block of image rows, and the few operations
that look across rows exchange what they need (the counterpart of the
halo exchanges and cross-shard reductions that XLA inserts for the JAX
package's ``P("dp", "sp", ...)`` shardings).

- A 3x3 convolution takes one halo row from each neighbouring rank, zeros
  at the image's top and bottom (SAME padding), and convolves with row
  padding 0 (:func:`halo_rows`).
- GroupNorm all-reduces the sums of ``g`` and ``g * g`` over the group; the
  style vector all-reduces its sum over rows and columns
  (:func:`all_reduce`). Both divide by the global count, which each rank
  knows from the split (:meth:`SpatialShard.global_count`).
- Average pooling and nearest up-sampling stay local, so every block
  boundary lies on a multiple of ``2 ** (levels - 1)`` rows
  (:func:`~aliby_tpu_torch.parallel.mesh.sp_rows`).

The collectives are ``torch.autograd.Function`` s over plain
``torch.distributed.all_reduce`` calls, so they work on gloo (CPU tensors,
and CUDA tensors, which gloo stages through the host) and on NCCL alike:

- an all-reduce's backward is the all-reduce of the incoming gradient
  (every rank used the sum, so each one's input owes the sum of their
  gradients);
- the halo's backward sends the halo rows' gradients back to the ranks
  that own those rows, which add them to their first and last rows.

The exchange of boundary rows is itself an all-reduce: each rank writes
its first and last rows into its own slot of a zeroed buffer of one slot a
rank, and the sum over ranks is every rank's rows (adding zeros is exact).
It is done in f32, which holds bf16 and f16 rows exactly.
"""

from __future__ import annotations

from typing import Sequence

import torch


class SpatialShard:
    """This rank's block of image rows in an sp group: ``rows`` are the
    level-0 rows of every rank of the group, in rank order."""

    def __init__(self, group, rank: int, rows: Sequence[int]):
        self.group = group
        self.rank = int(rank)
        self.rows = tuple(int(r) for r in rows)
        if not 0 <= self.rank < len(self.rows) or min(self.rows) < 1:
            raise ValueError(f"rank {rank} and rows {rows} make no shard")
        self.size = len(self.rows)
        self.total = sum(self.rows)
        self.own = self.rows[self.rank]

    def global_count(self, local_count: int) -> int:
        """The group's element count of a reduction of which this rank holds
        ``local_count`` elements (at any level: every level divides each
        block's rows by the same power of 2)."""
        return local_count * self.total // self.own

    def check_unit(self, unit: int) -> None:
        if any(r % unit for r in self.rows):
            raise ValueError(f"sp blocks of {self.rows} rows: each must be a multiple of "
                             f"{unit} (the U-Net's 2^(levels-1), so that pooling stays local)")


def _all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    dist.all_reduce(t, group=group)
    return t


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce_(grad.clone(memory_format=torch.contiguous_format), ctx.group), None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, with the gradient of a sum."""
    return _AllReduce.apply(x, group)


def _exchange(first: torch.Tensor, last: torch.Tensor, shard: SpatialShard):
    """Every rank sends ``first`` and ``last`` (the same shapes); returns
    the previous rank's ``last`` and the next rank's ``first``, zeros past
    either end of the group. f32, whatever the inputs' type."""
    buf = first.new_zeros((shard.size, 2) + tuple(first.shape), dtype=torch.float32)
    buf[shard.rank, 0] = first
    buf[shard.rank, 1] = last
    _all_reduce_(buf, shard.group)
    zero = buf.new_zeros(first.shape)
    above = buf[shard.rank - 1, 1] if shard.rank > 0 else zero
    below = buf[shard.rank + 1, 0] if shard.rank < shard.size - 1 else zero
    return above, below


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shard, r):
        ctx.shard, ctx.r = shard, r
        above, below = _exchange(x[:, :, :r], x[:, :, -r:], shard)
        return torch.cat([above.to(x.dtype), x, below.to(x.dtype)], dim=2)

    @staticmethod
    def backward(ctx, grad):
        r = ctx.r
        gx = grad[:, :, r:-r].clone(memory_format=torch.contiguous_format)
        # this rank's halo gradients belong to its neighbours' edge rows;
        # theirs to this rank's: the previous rank's lower halo is our
        # first rows, the next rank's upper halo our last rows
        from_above, from_below = _exchange(grad[:, :, :r], grad[:, :, -r:], ctx.shard)
        gx[:, :, :r] += from_above.to(gx.dtype)
        gx[:, :, -r:] += from_below.to(gx.dtype)
        return gx, None, None


def halo_rows(x: torch.Tensor, shard: SpatialShard, r: int = 1) -> torch.Tensor:
    """(B, C, h, W) block -> (B, C, h + 2r, W): ``r`` rows of the previous
    rank above and of the next rank below (zeros at the image's edges)."""
    if x.shape[2] < r:
        raise ValueError(f"a block of {x.shape[2]} rows cannot lend a halo of {r}")
    return _Halo.apply(x, shard, r)
