"""CLUB (Gentile et al. 2014; paper Listing 1), the sequential baseline
(``repro.core.club``).

One interaction at a time: the arriving user is scored with the
statistics of the cluster it belongs to, its own statistics and its
cluster's take the rank-1 update, and every ``delta_net`` interactions the
network is updated (edge pruning, connected components, the cluster
aggregates rebuilt from the users').  As in the reference, the cluster
aggregates are kept incrementally between network updates, so an
interaction costs O(K d^2), not Listing 1's O(n d^2) recomputation.

Per interaction on the card: the user's contexts (their row of the
synthetic draw only), one ``ucb`` launch for the K scores and a
first-index ``torch.argmax``, the reward, and two ``rank1_update``
launches in place on one-row views, the user's ``(M, Minv, b)`` (through
``InteractBackend.update_lin``, which also counts ``occ``) and the
cluster's ``(Mc, Mcinv, bc)``.  The user and the cluster label are host
ints (users are drawn on the host, the labels copied to the host once per
network update), so the loop never waits for the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from ..kernels.rank1 import ops as rank1_ops
from ..kernels.ucb import ops as ucb_ops
from ..runtime import stages
from ..runtime.collectives import NullCollectives
from . import clustering, linucb
from .backend import BackendConfig
from .env_ops import EnvOps
from .types import BanditHyper, ClusterStats, GraphState, LinUCBState, Metrics

_NULL = NullCollectives()
_ENGINE = BackendConfig.create().interact()


class CLUBState(NamedTuple):
    lin: LinUCBState
    graph: GraphState
    clusters: ClusterStats


def init_state(n_users: int, d: int, device=None) -> CLUBState:
    dev = resolve_device(device)
    lin = linucb.init_linucb(n_users, d, device=dev)
    graph = clustering.init_graph(n_users, device=dev)
    stats = clustering.cluster_stats(graph.labels, lin.M, lin.b, d)
    return CLUBState(lin, graph, stats)


def _network_update(state: CLUBState, hyper: BanditHyper,
                    d: int) -> CLUBState:
    """Prune the packed graph on the users' current vectors, relabel its
    components and rebuild the cluster statistics from ``lin.M``/``b``."""
    lin = state.lin
    n = lin.occ.shape[0]
    gb = BackendConfig.create().graph(n)
    v = linucb.user_vector(lin.Minv, lin.b)
    adj = gb.prune_rows(state.graph.adj, v, lin.occ, v, lin.occ, hyper.gamma)
    labels = stages.connected_components(_NULL, gb, adj, n, 0, n)
    stats = clustering.cluster_stats(labels, lin.M, lin.b, d)
    return CLUBState(lin, GraphState(adj=adj, labels=labels), stats)


def _clone(state: CLUBState) -> CLUBState:
    return CLUBState(*(type(rec)(*(t.clone() for t in rec)) for rec in state))


def run(
    ops: EnvOps,
    seed: int,
    hyper: BanditHyper,
    T: int,
    d: int,
    device=None,
    state: CLUBState | None = None,
    t0: int = 0,
) -> tuple[CLUBState, Metrics]:
    """``T`` sequential interactions on ``device`` (default ``cuda``;
    raises without a card unless ``device="cpu"``).

    Interaction ``t`` draws its user with ``ops.user_fn(seed, t)`` and its
    contexts and reward at step ``t``.  A run starts from a fresh state at
    ``t0 = 0``, or continues ``state`` (left as it was) from interaction
    ``t0``; the network updates after interaction ``t`` when
    ``(t + 1) % delta_net == 0``.  Returns (state, per-interaction
    Metrics ``[T]``).  ``ops`` must produce tensors on ``device``.
    """
    dev = resolve_device(device)
    # f32 products in full f32 on the card (see distclub.run)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = init_state(ops.n_users, d, device=dev) if state is None \
        else _clone(state)
    labels = state.graph.labels.tolist()
    live = torch.ones(1, dtype=torch.bool, device=dev)
    cols = []
    for t in range(t0, t0 + T):
        u = ops.user_fn(seed, t)
        lab = labels[u]
        lin, clu = state.lin, state.clusters
        occ = lin.occ[u:u + 1]
        contexts = ops.contexts_fn(seed, t, occ, row0=u)         # [1, K, d]
        Mcinv, bc = clu.Mcinv[lab:lab + 1], clu.bc[lab:lab + 1]
        w = linucb.user_vector(Mcinv, bc)
        scores = ucb_ops.ucb_scores(w, Mcinv, contexts, occ, hyper.alpha)
        choice = torch.argmax(scores, dim=-1)                   # first index
        x = torch.index_select(contexts[0], 0, choice)          # [1, d]
        realized, expected, best, rand = ops.rewards_fn(
            seed, t, occ, contexts, choice, row0=u)
        _ENGINE.update_lin(
            LinUCBState(lin.M[u:u + 1], lin.Minv[u:u + 1], lin.b[u:u + 1],
                        occ), x, realized, live)
        rank1_ops.rank1_update(clu.Mc[lab:lab + 1], Mcinv, bc, x, realized,
                               live)
        cols.append((realized, expected, best, rand))
        if (t + 1) % hyper.delta_net == 0:
            state = _network_update(state, hyper, d)
            labels = state.graph.labels.tolist()
    realized, expected, best, rand = (torch.cat(c) for c in zip(*cols))
    return state, Metrics(
        reward=realized, regret=best - expected, rand_reward=rand,
        interactions=torch.ones(T, dtype=torch.int32, device=dev))
