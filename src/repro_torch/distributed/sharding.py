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
tree (nested dicts, lists and NamedTuples of specs) beside a tree of
tensors.

The global-program cells (``launch.steps``) hold their arguments as
DTensors on the mesh's ``DeviceMesh``: ``placements`` turns a spec into
a DTensor's placements (``Partial`` on given axes for a gradient each
rank summed over its own batch rows).  ``zero_specs`` adds "data"
to a spec tree (the ZeRO layout of optimizer moments and gradient
accumulators), and ``hint``, under ``hint_mesh``, redistributes a
DTensor to a spec, where ``repro``'s puts a sharding constraint.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading

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
    """``fn(spec, leaf, *rest_leaves)`` over a spec tree (nested dicts,
    lists and NamedTuples of specs) and trees of the same keys; raises
    where the keys differ."""
    if isinstance(specs, P):
        return fn(specs, tree, *rest)
    if isinstance(specs, tuple) and hasattr(specs, "_fields"):
        return type(specs)(*(map_specs(fn, getattr(specs, f), getattr(
            tree, f), *(getattr(r, f) for r in rest))
            for f in specs._fields))
    if isinstance(specs, list):
        for t in (tree, *rest):
            if not isinstance(t, (list, tuple)) or len(t) != len(specs):
                raise ValueError(f"tree {type(t).__name__} against a list "
                                 f"of {len(specs)} specs")
        return [map_specs(fn, s, t, *(r[i] for r in rest))
                for i, (s, t) in enumerate(zip(specs, tree))]
    for t in (tree, *rest):
        if not isinstance(t, dict) or set(t) != set(specs):
            got = sorted(t) if isinstance(t, dict) else type(t).__name__
            raise ValueError(f"tree keys {got} against specs "
                             f"{sorted(specs)}")
    return {k: map_specs(fn, specs[k], tree[k], *(r[k] for r in rest))
            for k in specs}


def zero_specs(spec_tree, shape_tree, data_size: int):
    """ZeRO-shard a spec tree: add "data" on the largest still-replicated
    dim that ``data_size`` divides, in every leaf whose spec does not
    already name "data" (``repro``'s rule; the leaves of ``shape_tree``
    are ``(shape, dtype)``).  Optimizer moments and gradient accumulators
    take this layout: they carry no compute, so sharding them costs a
    reduce-scatter and an all-gather a step."""
    def one(spec, leaf):
        shape = leaf[0]
        entries = list(spec) + [None] * (len(shape) - len(spec))
        if any("data" in axes_tuple(e) for e in entries):
            return P(*entries)
        best, best_dim = 0, -1
        for i, e in enumerate(entries):
            if e is None and shape[i] % data_size == 0 and shape[i] > best:
                best, best_dim = shape[i], i
        if best_dim >= 0:
            entries[best_dim] = "data"
        return P(*entries)

    return map_specs(one, spec_tree, shape_tree)


def placements(spec: P, device_mesh, partial=()) -> tuple:
    """The DTensor placements of ``spec`` on ``device_mesh`` (its dims
    named as the spec's axes): ``Shard(dim)`` on each mesh dim an entry
    names, ``Partial()`` on the mesh dims of ``partial`` (axis names)
    the spec leaves free, ``Replicate()`` elsewhere.  A tuple entry
    splits its dim over its axes in the mesh's order, the first major,
    as JAX and ``shard`` split it."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    names = tuple(device_mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = axes_tuple(entry)
        pos = [names.index(a) for a in axes]
        if pos != sorted(set(pos)):
            raise ValueError(f"spec {spec}: axes {axes} are not in the "
                             f"mesh's order {names}")
        for i in pos:
            out[i] = Shard(dim)
    for a in partial:
        i = names.index(a)
        if out[i] == Replicate():
            out[i] = Partial()
    return tuple(out)


_HINT = threading.local()


@contextlib.contextmanager
def hint_mesh(mesh):
    """Make ``mesh`` the ambient mesh of ``hint`` inside the block."""
    prev = getattr(_HINT, "mesh", None)
    _HINT.mesh = mesh
    try:
        yield
    finally:
        _HINT.mesh = prev


def hint(x, *entries):
    """``x`` redistributed to ``P(*entries)`` when a hint mesh is active
    and ``x`` is a DTensor; else ``x`` untouched (a rank's local tensor
    already has its layout)."""
    from torch.distributed.tensor import DTensor

    if getattr(_HINT, "mesh", None) is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh,
                          placements(P(*entries), x.device_mesh))
