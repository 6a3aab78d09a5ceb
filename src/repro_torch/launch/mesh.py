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
"""
from __future__ import annotations

import datetime
import shutil
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..runtime.collectives import DistCollectives, bind


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
