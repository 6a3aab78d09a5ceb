"""Sharding helpers shared by the sharded runtimes, the serving sessions
and the sharded LM decode (``repro.distributed.sharding``:
``local_slice``, ``flat_axis_size``).

A spec (:class:`P`, ``repro``'s ``PartitionSpec``) has one entry a dim:
``None`` (replicated), a mesh-axis name, or a tuple of names (the dim
split over those axes together, row-major, the first axis major); dims
past its entries are replicated.  ``shard`` cuts a full tensor to one
rank's piece (the role of ``jax.device_put`` under a ``NamedSharding``),
``assemble`` puts the ranks' pieces back together (gathering to the
host), ``shard_shape`` is a piece's shape.  ``map_specs`` walks a spec
tree (nested dicts of specs) beside a tree of tensors.

``repro``'s ``hint_mesh``, ``hint`` and ``zero_specs`` are not ported
yet: the LM training cell, a GSPMD program, is their only caller, and
they come with the GSPMD cells (ROADMAP queue 1, item 9d-2).
"""
from __future__ import annotations

import dataclasses
import math

import torch


class P(tuple):
    """A partition spec: ``P(None, "model")``, ``P(("data", "model"))``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def axes_tuple(entry) -> tuple:
    """A spec entry (None, a name or a tuple of names) as a tuple."""
    if entry is None:
        return ()
    if isinstance(entry, str):
        return (entry,)
    return tuple(entry)


def flat_axis_size(mesh, axes) -> int:
    """The ranks along ``axes`` (one name or a tuple) together."""
    return math.prod(mesh.shape[a] for a in axes_tuple(axes))


def local_slice(n: int, axis_index: int, n_shards: int) -> tuple[int, int]:
    """(start, size) of shard ``axis_index``'s slice of an n-row axis;
    raises unless the shards divide it evenly."""
    if n % n_shards:
        raise ValueError(f"{n} rows do not divide evenly over {n_shards} "
                         "shards")
    size = n // n_shards
    return axis_index * size, size


def _pieces(shape, spec: P, mesh):
    """Per dim: (start, size) of this rank's piece."""
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than {shape} dims")
    out = []
    for dim, n in enumerate(shape):
        axes = spec[dim] if dim < len(spec) else None
        out.append(local_slice(n, mesh.axis_index(axes), mesh.size(axes)))
    return out


def shard_shape(shape, spec: P, mesh) -> tuple:
    """The shape of one rank's piece of a ``shape`` tensor under ``spec``
    (``NamedSharding.shard_shape``); raises unless every split dim
    divides evenly."""
    return tuple(size for _, size in _pieces(shape, spec, mesh))


def shard(x: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's piece of ``x`` under ``spec``, a view of ``x``."""
    for dim, (start, size) in enumerate(_pieces(x.shape, spec, mesh)):
        x = x.narrow(dim, start, size)
    return x


def assemble(pieces: list, spec: P, mesh) -> torch.Tensor:
    """The full tensor from every rank's piece (``pieces[r]`` rank
    ``r``'s, tensors or arrays) under ``spec`` on ``mesh`` (a description
    will do: only its axes are read)."""
    pieces = [torch.as_tensor(p) for p in pieces]
    full_shape = []
    for dim, n in enumerate(pieces[0].shape):
        entry = spec[dim] if dim < len(spec) else None
        full_shape.append(n * flat_axis_size(mesh, entry))
    out = pieces[0].new_empty(full_shape)
    for r, piece in enumerate(pieces):
        view = out
        rank_mesh = dataclasses.replace(mesh, rank=r, groups={})
        for dim, (start, size) in enumerate(
                _pieces(full_shape, spec, rank_mesh)):
            view = view.narrow(dim, start, size)
        view.copy_(piece)
    return out


def map_specs(fn, specs, tree, *rest):
    """``fn(spec, leaf, *rest_leaves)`` over a spec tree and trees of the
    same keys; raises where the keys differ."""
    if isinstance(specs, P):
        return fn(specs, tree, *rest)
    for t in (tree, *rest):
        if not isinstance(t, dict) or set(t) != set(specs):
            got = sorted(t) if isinstance(t, dict) else type(t).__name__
            raise ValueError(f"tree keys {got} against specs "
                             f"{sorted(specs)}")
    return {k: map_specs(fn, specs[k], tree[k], *(r[k] for r in rest))
            for k in specs}

