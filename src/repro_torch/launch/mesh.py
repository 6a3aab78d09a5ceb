"""Process groups for the sharded runtime (the role of
``repro.launch.mesh``, which builds a JAX device mesh).

One process per shard, each with one explicit device:

  nccl  rank ``r`` on ``cuda:r``; one rank per card, so ``world`` may not
        exceed ``torch.cuda.device_count()``.
  gloo  every rank on the device it is given: ``cpu``, or one card that
        several ranks share (NCCL refuses two ranks on one card).

:func:`spawn` starts the ranks (``torch.multiprocessing``, start method
``spawn``), rendezvous through a ``file://`` store in a fresh temporary
directory (no fixed TCP port, so concurrent callers never collide), runs
``fn(rank, col, device, *args)`` in each and returns every rank's result
with its tensors as numpy arrays.  Every rendezvous, collective and the
join have a time limit; a rank that raises, or a join past its limit,
fails the whole call.

Named axes (``repro``'s ``("data", "model")`` and ``("pod", "data",
"model")`` meshes): :class:`Mesh` lays the ranks out row-major over the
axes, the first axis major, as JAX numbers ``axis_index`` over a tuple
of axes.  ``mesh_spec`` describes a mesh and one rank's place in it
without any process group (the cell builder's shapes); ``make_mesh``,
called by every rank of a group, also binds the collectives of every
axis and of every tuple of axes (in the mesh's order) to a group of its
own.  A mesh of one rank gives ``NullCollectives`` on every axis.
``make_mesh`` also builds the ``DeviceMesh`` of the same named axes
(``init_device_mesh``, which lays the ranks out row-major as
``Mesh.coords`` does), on which the global-program cells hold their
arguments as DTensors; ``make_production_mesh`` is ``repro``'s (16, 16)
or (2, 16, 16) mesh on the world group.

The H100 figures below stand where ``repro`` has TPU v5e ones; the
roofline (``launch.roofline``) divides by them.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import shutil
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..distributed.sharding import (P, axes_tuple, flat_axis_size,
                                    placements)
from ..runtime.collectives import DistCollectives, NullCollectives, bind

# H100 SXM5 80GB roofline constants, per card
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, dense bf16 tensor cores (data sheet)
HBM_BW = 3.35e12              # B/s, HBM3 (data sheet)
HBM_BYTES = 80 * 1024 ** 3    # 80 GB HBM3 (data sheet: five 16 GiB
                              # stacks; torch reports 79.18 GiB usable)
# The collective term's per-card rate.  ``repro``'s 16-wide "model" axis
# spans two 8-card HGX nodes: inside a node each card has 450 GB/s a
# direction over NVLink 4 and NVSwitch (900 GB/s both ways, data sheet),
# but a ring over all 16 crosses the nodes, and each card's share of that
# hop is its own 400 Gb/s NDR InfiniBand port (ConnectX-7, one a card in
# the DGX H100 reference design), 50 GB/s a direction.  The slowest hop
# sets a ring's pace, so the ring is bounded by the port.
LINK_BW = 50e9                # B/s a direction, per card


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named mesh axes of ``sizes`` ranks each, and this rank's place:
    ranks are numbered row-major over the axes (the last axis minor).
    ``groups`` maps each tuple of axes (in the mesh's order) of more than
    one rank to the collectives bound to its group, ``device_mesh`` is
    the ``DeviceMesh`` of the same axes; a description made by
    ``mesh_spec`` has neither."""

    axis_names: tuple
    sizes: tuple
    rank: int = 0
    groups: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)
    device_mesh: object = dataclasses.field(default=None, compare=False,
                                            repr=False)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def n_ranks(self) -> int:
        return math.prod(self.sizes)

    @property
    def coords(self) -> tuple:
        """This rank's index on each axis."""
        out, r = [], self.rank
        for size in reversed(self.sizes):
            out.append(r % size)
            r //= size
        return tuple(reversed(out))

    def _order(self, axes) -> tuple:
        axes = axes_tuple(axes)
        pos = [self.axis_names.index(a) for a in axes]
        if pos != sorted(set(pos)):
            raise ValueError(f"axes {axes} are not distinct axes of "
                             f"{self.axis_names} in the mesh's order")
        return axes

    def size(self, axes) -> int:
        """The ranks along ``axes`` (one axis or a tuple) together."""
        return flat_axis_size(self, self._order(axes))

    def axis_index(self, axes) -> int:
        """This rank's row-major index over ``axes`` (a host int)."""
        coords = dict(zip(self.axis_names, self.coords))
        idx = 0
        for a in self._order(axes):
            idx = idx * self.shape[a] + coords[a]
        return idx

    def col(self, axes):
        """The collectives over ``axes``: ``NullCollectives`` where they
        hold one rank, else those of their group."""
        axes = self._order(axes)
        if self.size(axes) == 1:
            return NullCollectives()
        if axes not in self.groups:
            raise RuntimeError(f"mesh {self.shape} has no process group "
                               f"for {axes}: build it with make_mesh")
        return self.groups[axes]

    def group(self, axes):
        """The process group over ``axes``, or None where they hold one
        rank."""
        col = self.col(axes)
        return None if isinstance(col, NullCollectives) else col.group


def mesh_spec(shape, axis_names, rank: int = 0) -> Mesh:
    """A mesh of ``shape`` over ``axis_names`` seen from ``rank``, with no
    process group."""
    shape, axis_names = tuple(shape), tuple(axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"shape {shape} against axes {axis_names}")
    if not 0 <= rank < math.prod(shape):
        raise ValueError(f"rank {rank} outside a mesh of {shape}")
    return Mesh(axis_names, shape, rank)


def make_mesh(shape, axis_names, device_type=None) -> Mesh:
    """This rank's mesh of ``shape`` over ``axis_names``, on the world
    group (whose size must be the mesh's), with a group bound for every
    tuple of axes of more than one rank and, given a ``device_type``
    ("cuda" or "cpu"), the ``DeviceMesh`` of the same axes.  Every rank
    creates every group, in the same order.  Without an initialised group
    a mesh of one rank is returned as described."""
    if not dist.is_initialized():
        if device_type is not None:
            raise RuntimeError("a DeviceMesh needs an initialised process "
                               "group")
        if math.prod(shape) != 1:
            raise RuntimeError(f"a mesh of {tuple(shape)} needs an "
                               "initialised process group")
        return mesh_spec(shape, axis_names)
    m = mesh_spec(shape, axis_names, dist.get_rank())
    if dist.get_world_size() != m.n_ranks:
        raise ValueError(f"a mesh of {m.shape} on a group of "
                         f"{dist.get_world_size()} ranks")
    groups = {}
    names = m.axis_names
    coords = [mesh_spec(m.sizes, names, r).coords for r in range(m.n_ranks)]
    for k in range(1, len(names) + 1):
        for axes in itertools.combinations(names, k):
            if m.size(axes) == 1:
                continue
            # one group for each setting of the other axes' coordinates
            rest = [i for i, a in enumerate(names) if a not in axes]
            slices = {}
            for r, c in enumerate(coords):
                slices.setdefault(tuple(c[i] for i in rest), []).append(r)
            for ranks in slices.values():
                group = dist.new_group(ranks)
                if m.rank in ranks:
                    groups[axes] = bind(group)
    dm = None
    if device_type is not None:
        from torch.distributed.device_mesh import init_device_mesh
        dm = init_device_mesh(device_type, m.sizes, mesh_dim_names=names)
    return Mesh(names, m.sizes, m.rank, groups, dm)


def make_production_mesh(multi_pod: bool = False,
                         device_type: str = "cuda") -> Mesh:
    """``repro``'s production mesh on the world group: (16, 16) over
    ("data", "model"), or (2, 16, 16) over ("pod", "data", "model")."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"), device_type)
    return make_mesh((16, 16), ("data", "model"), device_type)


def batch_axes(mesh: Mesh) -> tuple:
    """Axes a batch or user dim shards over (pure DP across pods)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def all_axes(mesh: Mesh) -> tuple:
    return tuple(mesh.axis_names)


def resolve(mesh: Mesh, spec):
    """The DTensor placements of ``spec`` on the mesh's ``DeviceMesh``
    (``repro`` maps a logical spec onto the mesh unchanged)."""
    return placements(spec, mesh.device_mesh)


def batch_spec(mesh: Mesh, rank: int, sharded_dim: int = 0):
    """A rank-``rank`` spec with dim ``sharded_dim`` over the batch
    axes."""
    entries = [None] * rank
    entries[sharded_dim] = batch_axes(mesh)
    return P(*entries)


def init_group(backend: str, rank: int, world: int, init_method: str,
               timeout: float, device=None) -> DistCollectives:
    """Join the ``world``-rank group at ``init_method`` as ``rank``, with
    ``timeout`` seconds for the rendezvous and every collective; returns
    its collectives.  NCCL binds the group to ``device``."""
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout),
        device_id=torch.device(device) if backend == "nccl" else None)
    return bind()


def rank_devices(world: int, backend: str, device=None) -> list:
    """Each rank's device: ``cuda:r`` under nccl, ``device`` under gloo."""
    if backend == "nccl":
        cards = torch.cuda.device_count()
        if world > cards:
            raise ValueError(f"nccl takes one rank per card: {world} ranks "
                             f"on {cards} cards")
        return [torch.device("cuda", r) for r in range(world)]
    if backend == "gloo":
        if device is None:
            raise ValueError("gloo ranks need an explicit device")
        return [torch.device(device)] * world
    raise ValueError(f"unknown backend {backend!r}; want nccl or gloo")


def _host(x):
    """``x`` with every tensor in it moved to a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_host(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    return x


def _rank_main(rank, world, backend, devices, timeout, out_dir, threads):
    torch.set_num_threads(threads)
    dev = devices[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    out_dir = Path(out_dir)
    fn, args = torch.load(out_dir / "call.pt", weights_only=False)
    col = init_group(backend, rank, world, f"file://{out_dir / 'store'}",
                     timeout, dev)
    try:
        out = fn(rank, col, dev, *args)
        torch.save(_host(out), out_dir / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, backend: str = "gloo", device=None, args=(),
          timeout: float = 60.0) -> list:
    """Run ``fn(rank, col, device, *args)`` in ``world`` processes of one
    group and return each rank's result (tensors as numpy arrays), in
    rank order.  ``fn`` and ``args`` must pickle (a module-level
    function).  Raises if a rank raises, or if the ranks have not all
    finished ``timeout`` seconds after the start (the ranks are then
    killed).  Each rank runs with the caller's intra-op thread count."""
    devices = rank_devices(world, backend, device)
    tmp = Path(tempfile.mkdtemp(prefix="repro_torch_mesh_"))
    try:
        # the call goes through a file: a process under ``spawn`` reads its
        # arguments only after it has imported the caller's main module, and
        # arguments larger than a pipe's buffer would hold the caller until
        # then, one rank after another
        torch.save((fn, tuple(args)), tmp / "call.pt")
        ctx = mp.start_processes(
            _rank_main, nprocs=world, join=False, start_method="spawn",
            args=(world, backend, devices, timeout, str(tmp),
                  torch.get_num_threads()))
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(0.0, min(
                1.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    p.kill()
                for p in ctx.processes:
                    p.join(10)
                raise TimeoutError(f"{world} {backend} ranks did not finish "
                                   f"within {timeout} s")
        return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
                for r in range(world)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
