"""The communication protocol the stage engine is written against.

The DistCLUB stages need four primitives: ``axis_index()`` (which user
shard am I), ``all_gather(x)`` over the user axis, ``psum(x)`` and
``n_shards``; the sharded DCCB adds ``permute(x)``, its ring gossip, and
the sharded GAT ``psum_scatter(x)``, the backward of its feature gather.
The LM's tensor-parallel body adds ``pmax(x)``, and ``permute(x)`` for
a neighbour's columns of ``wq``; it and the GAT reach these through the
differentiable wrappers of ``distributed.spmd``.
The sharded LM decode gathers on another dim, ``all_gather(x, axis=1)``
(``jax.lax.all_gather(..., axis=1, tiled=True)``), and stacks the pieces
on a new leading dim, ``all_gather(x, tiled=False)``; it binds one set
of these per named mesh axis (``launch.mesh.Mesh``).

  ``NullCollectives``  one process: every primitive is the identity.
  ``DistCollectives``  bound to a ``torch.distributed`` process group
                       (``repro.runtime.collectives.LaxCollectives``):
                       ``axis_index`` is the rank, a Python int, so the
                       stage bodies' ``row0`` stays a host int.

``BYTES`` counts what each process puts on the wire, by primitive (the
counterpart of ``kernels/_build.LAUNCHES``), under the ring schedules:
an all-gather sends this rank's piece to each of the ``S - 1`` others,
an all-reduce ``2 (S - 1) / S`` of the tensor (reduce-scatter, then
all-gather), a reduce-scatter ``(S - 1) / S`` (its key appears once
one has run: only the sharded GAT's backward runs it), a permute the
whole tensor.  One process sends nothing.
A run prints it beside the modelled ``stages.stage2_comm_bytes``.

gloo moves host memory only, and refuses CUDA tensors for some of these
primitives; so by choice of backend, a gloo group stages every primitive
on a CUDA tensor through host memory (``host_staged``).  NCCL never does.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist

BYTES = {"all_gather": 0, "psum": 0, "permute": 0}


def reset_bytes() -> None:
    for name in BYTES:
        BYTES[name] = 0


class NullCollectives(NamedTuple):
    """Single process: one shard, every collective is the identity."""

    @property
    def n_shards(self) -> int:
        return 1

    def axis_index(self) -> int:
        return 0

    def all_gather(self, x, axis: int = 0, tiled: bool = True):
        return x if tiled else x.unsqueeze(axis)

    def psum(self, x):
        return x

    def psum_scatter(self, x, axis: int = 0):
        return x

    def pmax(self, x):
        return x


class DistCollectives(NamedTuple):
    """The primitives on a ``torch.distributed`` process group (users =
    the group's ranks, in rank order).  Build it with :func:`bind` after
    ``init_process_group``."""

    group: object            # the ProcessGroup (None: the default group)
    rank: int
    shards: int
    host_staged: bool        # gloo: CUDA tensors go through host memory
    wide: bool = True        # a bf16 sum in f32, rounded once (False: in
                             # bf16, the LM's tensor-parallel sums)

    @property
    def n_shards(self) -> int:
        return self.shards

    def axis_index(self) -> int:
        return self.rank

    def _stage(self, x):
        return x.cpu() if self.host_staged and x.is_cuda else x

    def all_gather(self, x, axis: int = 0, tiled: bool = True):
        """Every rank's ``x`` in rank order, tiled on dim ``axis`` ([..., S
        * n, ...]), or with ``tiled=False`` stacked on a new dim there
        ([..., S, n, ...]), as ``jax.lax.all_gather(x, axis=, tiled=)``.
        The wire carries dim 0 first: another dim is moved there and
        back."""
        if not tiled:
            return self.all_gather(x.unsqueeze(axis), axis)
        BYTES["all_gather"] += x.nbytes * (self.shards - 1)
        src = self._stage(x.movedim(axis, 0).contiguous())
        out = src.new_empty((self.shards * src.shape[0], *src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=self.group)
        return out.movedim(0, axis).to(x.device)

    def _widen(self, y):
        return y.float() if self.wide and y.dtype == torch.bfloat16 else y

    def psum(self, x):
        """The sum over ranks, on a copy (the caller's tensor is left as
        it was).  A bf16 ``x`` is summed in f32 and rounded once (under
        ``wide``), as ``psum_scatter`` sums it."""
        BYTES["psum"] += x.nbytes * 2 * (self.shards - 1) // self.shards
        y = self._widen(self._stage(x))
        y = y.clone() if y is x else y
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=self.group)
        return y.to(device=x.device, dtype=x.dtype)

    def psum_scatter(self, x, axis: int = 0):
        """This rank's piece of the sum over ranks, tiled on dim ``axis``
        (``jax.lax.psum_scatter(..., scatter_dimension=axis,
        tiled=True)``): ``x`` [S * n, ...] -> [n, ...] on dim 0.  A bf16
        ``x`` is summed in f32 and rounded once (under ``wide``), as
        ``repro``'s reduction rounds it."""
        BYTES["psum_scatter"] = (BYTES.get("psum_scatter", 0) + x.nbytes
                                 * (self.shards - 1) // self.shards)
        src = self._widen(self._stage(x.movedim(axis, 0).contiguous()))
        out = src.new_empty((src.shape[0] // self.shards, *src.shape[1:]))
        dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM,
                                   group=self.group)
        return out.movedim(0, axis).to(device=x.device, dtype=x.dtype)

    def pmax(self, x):
        """The elementwise max over ranks, on a copy."""
        y = self._stage(x).clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=self.group)
        return y.to(x.device)

    def permute(self, x, shift: int = 1):
        """The ring exchange: rank ``r`` sends ``x`` to ``r + shift`` and
        returns what ``r - shift`` sent (mod S)."""
        if self.shards == 1:
            return x.clone()
        BYTES["permute"] += x.nbytes
        src = self._stage(x.contiguous())
        out = torch.empty_like(src)
        peer = (self.rank + shift) % self.shards
        back = (self.rank - shift) % self.shards
        if self.group is not None:      # point to point takes world ranks
            peer, back = (dist.get_global_rank(self.group, r)
                          for r in (peer, back))
        for work in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, src, peer, group=self.group),
                dist.P2POp(dist.irecv, out, back, group=self.group)]):
            work.wait()
        return out.to(x.device)


def bind(group=None) -> DistCollectives:
    """Collectives over ``group`` (default: the world group)."""
    return DistCollectives(group=group, rank=dist.get_rank(group),
                           shards=dist.get_world_size(group),
                           host_staged=dist.get_backend(group) == "gloo")
