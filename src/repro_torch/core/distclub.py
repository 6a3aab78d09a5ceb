"""DistCLUB in one process: the stage engine run with null
collectives (one shard, every collective the identity, row0 = 0).

Stage 1  user-based LinUCB rounds     all users advance in parallel,
                                      masked by ``u_rounds``
Stage 2  network update + clustering  edge pruning, connected components,
                                      cluster statistics
Stage 3  cluster-based UCB rounds     as stage 1, scored with the FROZEN
                                      stage-2 cluster snapshots except for
                                      the paper's beta-heuristic users
Stage 4  budget rebalancing           against the stage-2 mean-occ snapshot

The engine is M-free: the rounds carry only ``Minv``; stage 2 recovers M
by inversion and ``run`` refreshes ``lin.M`` once at the end
(:func:`refresh_gram`).  Python loops take the place of the reference's
``lax.scan`` over epochs and rounds.  On CUDA tensors the rounds and the
graph sweeps go through the hand-written kernels of ``kernels/``.
"""
from __future__ import annotations

import torch

from .. import resolve_device
from ..runtime import stages
from ..runtime.collectives import NullCollectives
from . import clustering, linucb
from .backend import BackendConfig
from .env_ops import EnvOps
from .types import BanditHyper, ClusterStats, DistCLUBState, GraphState, Metrics

_NULL = NullCollectives()
_ENGINE = BackendConfig.create().interact()


def init_state(n_users: int, d: int, hyper: BanditHyper,
               device=None) -> DistCLUBState:
    dev = resolve_device(device)
    lin = linucb.init_linucb(n_users, d, device=dev)
    graph = clustering.init_graph(n_users, device=dev)
    stats = clustering.cluster_stats(graph.labels, lin.M, lin.b, d)
    rounds = torch.full((n_users,), hyper.sigma, dtype=torch.int32,
                        device=dev)
    return DistCLUBState(
        lin=lin, graph=graph, clusters=stats, u_rounds=rounds,
        c_rounds=rounds.clone(),
        comm_bytes=torch.zeros((), dtype=torch.float32, device=dev),
    )


def _with_lin(state: DistCLUBState, Minv, b, occ) -> DistCLUBState:
    """Fold engine outputs back into the record; ``lin.M`` is left alone
    (see :func:`refresh_gram`)."""
    return state._replace(lin=state.lin._replace(Minv=Minv, b=b, occ=occ))


def serving_snapshot(state: DistCLUBState):
    """Per-user cluster snapshots ``(uMcinv, ubc, umean_occ)`` gathered
    from the label-indexed stage-2 tables."""
    labels = state.graph.labels.long()
    stats = state.clusters
    return (stats.Mcinv[labels], stats.bc[labels],
            stages.snapshot_mean_occ(stats.seen, stats.size, labels))


def refresh_gram(state: DistCLUBState) -> DistCLUBState:
    """Recover ``lin.M = inv(lin.Minv)``, row-major like the rest of the
    state (a batched inverse on CUDA comes back column-major)."""
    return state._replace(lin=state.lin._replace(
        M=torch.linalg.inv(state.lin.Minv).contiguous()))


def stage1(state: DistCLUBState, ops: EnvOps, seed: int, step0: int,
           hyper: BanditHyper):
    """User-based rounds; ``step0`` is the global id of the first round."""
    Minv, b, occ, metrics = stages.personalized_rounds(
        _ENGINE, ops, hyper, seed, step0, state.lin.Minv, state.lin.b,
        state.lin.occ, state.u_rounds, row0=0)
    return _with_lin(state, Minv, b, occ), metrics


def stage2(state: DistCLUBState, hyper: BanditHyper, d: int) -> DistCLUBState:
    """Network update, clustering, cluster statistics (the comm stage)."""
    gb = BackendConfig.create().graph(state.graph.labels.shape[0])
    res = stages.stage2_refresh(
        _NULL, gb, hyper, d, state.lin.Minv, state.lin.b, state.lin.occ,
        state.graph.adj)
    stats = ClusterStats(Mc=res.Mc, Mcinv=torch.linalg.inv(res.Mc),
                         bc=res.bc, size=res.size, seen=res.seen)
    return state._replace(
        graph=GraphState(adj=res.adj, labels=res.labels), clusters=stats,
        comm_bytes=state.comm_bytes + res.comm_bytes)


def stage3(state: DistCLUBState, ops: EnvOps, seed: int, step0: int,
           hyper: BanditHyper):
    """Cluster-based rounds with the beta heuristic; the stage-2
    snapshots stay frozen for the whole stage."""
    uMcinv, ubc, umean_occ = serving_snapshot(state)
    Minv, b, occ, metrics = stages.cluster_rounds(
        _ENGINE, ops, hyper, seed, step0, state.lin.Minv, state.lin.b,
        state.lin.occ, state.c_rounds, 0, uMcinv, ubc, umean_occ)
    return _with_lin(state, Minv, b, occ), metrics


def stage4(state: DistCLUBState, hyper: BanditHyper) -> DistCLUBState:
    """Rebalance per-user budgets against the stage-2 mean-occ snapshot."""
    umean_occ = stages.snapshot_mean_occ(
        state.clusters.seen, state.clusters.size, state.graph.labels)
    u_rounds, c_rounds = stages.stage4_rebalance(
        hyper, state.lin.occ, umean_occ, state.u_rounds, state.c_rounds)
    return state._replace(u_rounds=u_rounds, c_rounds=c_rounds)


def epoch(state: DistCLUBState, ops: EnvOps, seed: int, e: int,
          hyper: BanditHyper, d: int):
    """Epoch ``e`` of the four-stage loop: ``(state, Metrics [2 max_rounds],
    n_clusters after stage 2)``.  Stage 1 draws global rounds
    ``2 e R ..``, stage 3 ``(2 e + 1) R ..`` with ``R = max_rounds``."""
    R = hyper.max_rounds
    state, m1 = stage1(state, ops, seed, 2 * e * R, hyper)
    state = stage2(state, hyper, d)
    n_clu = clustering.num_clusters(state.graph.labels)
    state, m3 = stage3(state, ops, seed, (2 * e + 1) * R, hyper)
    state = stage4(state, hyper)
    return state, Metrics(*(torch.cat([a, b]) for a, b in zip(m1, m3))), n_clu


def run(
    ops: EnvOps,
    seed: int,
    hyper: BanditHyper,
    n_epochs: int,
    d: int,
    device=None,
) -> tuple[DistCLUBState, Metrics, torch.Tensor]:
    """Run ``n_epochs`` of the four-stage loop on ``device`` (default
    ``cuda``; raises without a card unless ``device="cpu"``).

    Returns (final state with ``lin.M`` refreshed, per-round Metrics
    ``[n_epochs * 2 * max_rounds]``, cluster count after each stage 2
    ``[n_epochs]``).  ``ops`` must produce tensors on ``device``.
    """
    dev = resolve_device(device)
    # f32 products stay full f32 on the card: TF32 would round the UCB
    # scores, the Sherman-Morrison state and the stage-2 distances to ~3
    # decimal digits and move choices and edge bits against the reference.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = init_state(ops.n_users, d, hyper, device=dev)
    per_epoch, n_clusters = [], []
    for e in range(n_epochs):
        state, metrics, n_clu = epoch(state, ops, seed, e, hyper, d)
        per_epoch.append(metrics)
        n_clusters.append(n_clu)
    metrics = Metrics(*(torch.cat(col) for col in zip(*per_epoch)))
    return refresh_gram(state), metrics, torch.stack(n_clusters)
