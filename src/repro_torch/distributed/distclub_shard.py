"""Sharded DistCLUB: the shared stage engine on ``torch.distributed``
(``repro.distributed.distclub_shard``).

No stage logic lives here: the four stage bodies of ``runtime.stages``
are bound to a ``runtime.collectives.DistCollectives`` (the one-process
driver, ``core.distclub``, binds them to ``NullCollectives``).  Users are
the distribution axis, split over the group's ranks in rank order; each
rank is one process and holds only its own shard:

  Minv, b, occ, u_rounds, c_rounds : its rows      [n_local, ...]
  adj (bit-packed int32 words)     : its rows      [n_local, ceil(n/32)]
  labels                           : replicated    [n]
  comm_bytes                       : replicated    modelled stage-2 bytes

So ``repro``'s ``state_specs`` and ``named_shardings`` have no
counterpart here; :func:`gather_state` assembles the global state where a
caller needs it whole.

Stages 1, 3 and 4 are local.  Stage 2 is the only communicating stage:
an all-gather of the user vectors and ``occ`` for edge pruning, one
all-gather of the labels per connected-components hop, and the psum of
the ``(n, d, d) + (n, d)`` cluster aggregates.  The adjacency never
crosses the network: each rank prunes and hops its own packed rows
(``R = n_local`` rows against ``C = n`` columns).

Any ``EnvOps`` runs here (synthetic, drift, replay, catalog): its tables
are held whole by every rank and sliced by ``row0``, and every draw is
keyed by global user id and the ``(seed, e)`` round schedule of
``core.distclub.epoch``, so a sharded run draws what a one-process run
draws.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from ..core.backend import BackendConfig
from ..core.env_ops import EnvOps, default_synthetic_ops
from ..core.types import BanditHyper, Metrics
from ..kernels.graph import ops as graph_ops
from ..runtime import stages
from .sharding import local_slice

_ENGINE = BackendConfig.create().interact()


class ShardedDistCLUB(NamedTuple):
    """One rank's state: its users' rows, the replicated labels and the
    replicated modelled-bytes counter.  ``Minv`` is carried, ``M`` is not
    (stage 2 recovers it by inversion)."""

    Minv: torch.Tensor        # [n_local, d, d]
    b: torch.Tensor           # [n_local, d]
    occ: torch.Tensor         # [n_local] i32
    adj: torch.Tensor         # [n_local, ceil(n/32)] i32 packed rows
    labels: torch.Tensor      # [n] i32 replicated
    u_rounds: torch.Tensor    # [n_local] i32
    c_rounds: torch.Tensor    # [n_local] i32
    comm_bytes: torch.Tensor  # [] f32 replicated


def init_state(n: int, d: int, hyper: BanditHyper, col,
               device=None) -> ShardedDistCLUB:
    """This rank's initial shard on ``device`` (default cuda; raises
    without a card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    row0, n_local = local_slice(n, col.axis_index(), col.n_shards)
    eye = torch.eye(d, dtype=torch.float32, device=dev)
    rounds = torch.full((n_local,), hyper.sigma, dtype=torch.int32,
                        device=dev)
    return ShardedDistCLUB(
        Minv=eye.expand(n_local, d, d).clone(),
        b=torch.zeros(n_local, d, dtype=torch.float32, device=dev),
        occ=torch.zeros(n_local, dtype=torch.int32, device=dev),
        adj=graph_ops.init_packed_adj(n_local, n, row_offset=row0,
                                      device=dev),
        labels=torch.zeros(n, dtype=torch.int32, device=dev),
        u_rounds=rounds, c_rounds=rounds.clone(),
        comm_bytes=torch.zeros((), dtype=torch.float32, device=dev))


def build_epoch_fn(col, n: int, d: int, hyper: BanditHyper,
                   ops: EnvOps | None = None, device=None):
    """``epoch(state, seed, e) -> (state, metrics, n_clusters)``, epoch
    ``e`` on this rank.  ``metrics`` holds ``[2 max_rounds]`` rows (stage 1,
    then stage 3) summed over the ranks, the layout of one epoch of
    ``core.distclub``; ``n_clusters`` is the count after stage 2.
    ``ops`` defaults to ``env_ops.default_synthetic_ops`` on ``device``."""
    dev = resolve_device(device)
    row0, n_local = local_slice(n, col.axis_index(), col.n_shards)
    gb = BackendConfig.create().graph(n_local, n)
    env = ops or default_synthetic_ops(n, d, hyper.n_candidates, device=dev)
    R = hyper.max_rounds

    def epoch(state: ShardedDistCLUB, seed: int, e: int):
        Minv, b, occ, m1 = stages.personalized_rounds(
            _ENGINE, env, hyper, seed, 2 * e * R, state.Minv, state.b,
            state.occ, state.u_rounds, row0)
        res = stages.stage2_refresh(col, gb, hyper, d, Minv, b, occ,
                                    state.adj)
        Minv, b, occ, m3 = stages.cluster_rounds(
            _ENGINE, env, hyper, seed, (2 * e + 1) * R, Minv, b, occ,
            state.c_rounds, row0, res.uMcinv, res.ubc, res.umean_occ)
        u_rounds, c_rounds = stages.stage4_rebalance(
            hyper, occ, res.umean_occ, state.u_rounds, state.c_rounds)
        metrics = Metrics(*(col.psum(torch.cat([a, b_]))
                            for a, b_ in zip(m1, m3)))
        return ShardedDistCLUB(
            Minv=Minv, b=b, occ=occ, adj=res.adj, labels=res.labels,
            u_rounds=u_rounds, c_rounds=c_rounds,
            comm_bytes=state.comm_bytes + res.comm_bytes), \
            metrics, res.n_clusters

    return epoch


def make_runtime(col, n: int, d: int, hyper: BanditHyper,
                 ops: EnvOps | None = None, device=None):
    """``(init_fn, epoch_fn)`` for this rank: ``init_fn()`` is its initial
    shard, ``epoch_fn`` as :func:`build_epoch_fn`.  ``device`` defaults to
    cuda and raises without a card unless ``device="cpu"``; under nccl it
    is the rank's own card.  ``ops`` must produce tensors there."""
    dev = resolve_device(device)
    epoch = build_epoch_fn(col, n, d, hyper, ops, dev)
    # f32 products stay full f32 on the card (see core.distclub.run)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return (lambda: init_state(n, d, hyper, col, dev)), epoch


def gather_state(state: ShardedDistCLUB, col) -> ShardedDistCLUB:
    """The global state ``[n, ...]`` on every rank: the sharded rows
    all-gathered in rank order (the replicated fields as they are)."""
    sharded = ("Minv", "b", "occ", "adj", "u_rounds", "c_rounds")
    return state._replace(**{f: col.all_gather(getattr(state, f))
                             for f in sharded})
