"""Differentiable collectives, and the axes a rank's body runs them over.

The port's global-program cells run a body on each rank's local shards
(the role of the program GSPMD partitions for ``repro``); the LM's
tensor-parallel body (``models.transformer`` and the modules it calls,
with an :class:`Axes`) and the sharded GAT loss (``models.gnn``) both
take their gradients through these wrappers.  Each takes a collectives
object of ``runtime.collectives`` (``launch.mesh.Mesh.col``): on
``NullCollectives``, or any group of one rank, it is the identity.

The backward of each follows how the ranks' losses combine.  Over
"model" every rank computes the same loss (tensor parallelism,
Megatron-LM's f and g):

  ``enter``   identity forward, all-reduce backward: a replicated value
              entering a region where each rank computes a part;
  ``leave``   all-reduce forward, identity backward: the parts summed
              back into a replicated value.

Over the batch axes each rank's loss is its own rows' share, and the
shares add up (``repro``'s shard_map transposes):

  ``psum``    all-reduce forward and backward;
  ``gather``  all-gather forward, reduce-scatter backward (also a
              weight split over "data", gathered where it is used);
  ``shift``   a ring exchange forward, the reverse exchange backward (a
              neighbour's columns of a weight, used where they are).

``pmax`` and ``gather_nograd`` carry no gradient.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..runtime.collectives import NullCollectives


class Axes(NamedTuple):
    """The collectives a rank of an LM cell runs over: "model", the batch
    axes together, and "data" alone (the experts' ZeRO split), with each
    batch axis's ranks in the mesh's order."""

    model: object = NullCollectives()
    batch: object = NullCollectives()
    data: object = NullCollectives()
    batch_sizes: tuple = ()

    @property
    def m(self) -> int:
        return self.model.n_shards

    @property
    def r(self) -> int:
        return self.model.axis_index()

    @property
    def nb(self) -> int:
        return self.batch.n_shards

    @property
    def rb(self) -> int:
        return self.batch.axis_index()


ONE_RANK = Axes()


def _in_dtype(col):
    """``col`` summing bf16 in bf16 (the tensor-parallel sums)."""
    return col if isinstance(col, NullCollectives) else col._replace(
        wide=False)


def axes(mesh, batch_axes) -> Axes:
    """This rank's :class:`Axes` on ``mesh`` (a ``launch.mesh.Mesh``)."""
    return Axes(_in_dtype(mesh.col("model")), _in_dtype(mesh.col(batch_axes)),
                _in_dtype(mesh.col("data")),
                tuple(mesh.shape[a] for a in batch_axes))


def most_rows(rows: int, ax: Axes) -> int:
    """The most rows of a ``rows``-row batch a rank holds: DTensor splits
    a dim over several axes one after the other, the first pieces one
    row longer where they do not divide it."""
    for n in ax.batch_sizes:
        rows = -(-rows // n)
    return rows


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, col):
        ctx.col = col
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.col.psum(g), None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, col):
        return col.psum(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, col):
        ctx.col = col
        return col.psum(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.col.psum(g), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, col):
        ctx.dim, ctx.col = dim, col
        return col.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.col.psum_scatter(g, ctx.dim), None, None


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s, col):
        ctx.s, ctx.col = s, col
        return col.permute(x, s)

    @staticmethod
    def backward(ctx, g):
        return ctx.col.permute(g, -ctx.s), None, None


def enter(x, col):
    return x if col.n_shards == 1 else _Enter.apply(x, col)


def leave(x, col):
    return x if col.n_shards == 1 else _Leave.apply(x, col)


def psum(x, col):
    return x if col.n_shards == 1 else _Psum.apply(x, col)


def gather(x, dim: int, col):
    """Every rank's ``x`` in rank order, tiled on ``dim``."""
    return x if col.n_shards == 1 else _Gather.apply(x, dim % x.dim(), col)


def shift(x, s: int, col):
    """Rank ``r - s``'s ``x`` on rank ``r`` (mod the ranks)."""
    return x if col.n_shards == 1 else _Shift.apply(x, s, col)


def gather_nograd(x, dim: int, col):
    return x if col.n_shards == 1 else col.all_gather(x, dim % x.dim())


def pmax(x, col):
    return x if col.n_shards == 1 else col.pmax(x.detach())
