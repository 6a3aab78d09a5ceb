"""Sharding helpers shared by the sharded runtimes and the serving
sessions (``repro.distributed.sharding``: ``local_slice``).
``hint_mesh``/``hint``/``zero_specs`` serve the MoE and training paths of
``repro`` and are not ported yet."""
from __future__ import annotations


def local_slice(n: int, axis_index: int, n_shards: int) -> tuple[int, int]:
    """(start, size) of shard ``axis_index``'s slice of an n-row axis;
    raises unless the shards divide it evenly."""
    if n % n_shards:
        raise ValueError(f"{n} rows do not divide evenly over {n_shards} "
                         "shards")
    size = n // n_shards
    return axis_index * size, size
