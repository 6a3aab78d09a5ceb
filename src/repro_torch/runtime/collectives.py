"""The communication protocol the stage engine is written against.

The DistCLUB stages need four primitives: ``axis_index()`` (which user
shard am I), ``all_gather(x)`` over the user axis, ``psum(x)`` and
``n_shards``.  ``NullCollectives`` is the single-process binding, every
primitive the identity; a ``torch.distributed`` binding is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple


class NullCollectives(NamedTuple):
    """Single process: one shard, every collective is the identity."""

    @property
    def n_shards(self) -> int:
        return 1

    def axis_index(self) -> int:
        return 0

    def all_gather(self, x):
        return x

    def psum(self, x):
        return x
