"""The four DistCLUB stages (paper Listing 3), written once.

Every function operates on a LOCAL user slice ``[n_local, ...]`` and a
``Collectives`` binding (``runtime.collectives``):

  stage 1  ``personalized_rounds``  zero communication
  stage 2  ``stage2_refresh``       edge pruning, connected components
                                    and the cluster aggregates (the
                                    paper's treeReduce, a psum)
  stage 3  ``cluster_rounds``       zero communication (stats frozen)
  stage 4  ``stage4_rebalance``     zero communication

Semantics follow ``repro.runtime.stages`` exactly: the per-user cluster
snapshots (``Mcinv[label]``, ``bc[label]`` and the cluster mean
occupancy) are taken at stage 2 and frozen through stages 3 and 4; the
budget shift truncates toward zero; the CC loop is capped at n hops; and
``comm_bytes`` is an f32 accumulator.

Environment draws are keyed by ``(seed, step)`` where ``step`` is the
run's global round id (see ``core.env_ops``): stage bodies take the id of
their first round, ``step0``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core import linucb
from ..core.clustering import num_clusters, segment_sum
from ..core.types import Metrics

# ---------------------------------------------------------------------------
# the shared interaction loop (stage 1, stage 3, DCCB's rounds)
# ---------------------------------------------------------------------------


def _metrics_of(realized, expected, best, rand, mask):
    m = mask.to(realized.dtype)
    return (torch.sum(realized * m), torch.sum((best - expected) * m),
            torch.sum(rand * m), torch.sum(mask.to(torch.int32)).to(
                torch.int32))


def interaction_rounds(be, ops, hyper, seed, step0, carry0, *, row0, n_steps,
                       occ_of, score_fn, update_fn, budget):
    """``n_steps`` lockstep interaction rounds over a local user slice.

    One round = one (masked) interaction for every local user:

      contexts  = ops.contexts_fn(seed, step, occ, row0)   # env draw
      w, Minv   = score_fn(carry)                          # stage-specific
      x, choice = be.choose(w, Minv, contexts, occ, alpha) # fused engine
      rewards   = ops.rewards_fn(seed, step, occ, contexts, choice, row0)
      carry     = update_fn(carry, t, x, realized, mask)

    ``budget`` (``[n_local] i32``) masks users whose budget is spent at
    round ``t``; ``None`` keeps every user live every round (DCCB).
    Returns ``(carry, Metrics)`` with one row per round, ``[n_steps]``
    (local sums).
    """
    carry = carry0
    rows = []
    for t in range(n_steps):
        step = step0 + t
        occ = occ_of(carry)
        mask = (torch.ones(occ.shape, dtype=torch.bool, device=occ.device)
                if budget is None else t < budget)
        contexts = ops.contexts_fn(seed, step, occ, row0)
        w, minv_eff = score_fn(carry)
        x, choice = be.choose(w, minv_eff, contexts, occ, hyper.alpha)
        realized, expected, best, rand = ops.rewards_fn(
            seed, step, occ, contexts, choice, row0)
        carry = update_fn(carry, t, x, realized, mask)
        rows.append(_metrics_of(realized, expected, best, rand, mask))
    return carry, Metrics(*(torch.stack(col) for col in zip(*rows)))


def _linucb_update(be):
    """The DistCLUB per-round update: M-free fused Sherman-Morrison."""

    def update(carry, t, x, realized, mask):
        Minv, b, occ = carry
        Minv, b = be.update_inv(Minv, b, x, realized, mask)
        return Minv, b, occ + mask.to(torch.int32)

    return update


def _bandit_rounds(be, ops, hyper, seed, step0, Minv, b, occ, budget, row0,
                   score_fn):
    # the engine updates Minv and b in place: hand it private copies so the
    # caller's state is left as it was
    carry0 = (Minv.clone(), b.clone(), occ)
    (Minv, b, occ), metrics = interaction_rounds(
        be, ops, hyper, seed, step0, carry0, row0=row0,
        n_steps=hyper.max_rounds, occ_of=lambda c: c[2], score_fn=score_fn,
        update_fn=_linucb_update(be), budget=budget)
    return Minv, b, occ, metrics


def personalized_rounds(be, ops, hyper, seed, step0, Minv, b, occ, budget,
                        row0):
    """Stage 1: user-based LinUCB rounds, embarrassingly parallel."""

    def score_own(carry):
        Minv_, b_, _ = carry
        return linucb.user_vector(Minv_, b_), Minv_

    return _bandit_rounds(be, ops, hyper, seed, step0, Minv, b, occ, budget,
                          row0, score_own)


def beta_gate(hyper, occ, umean_occ):
    """The paper's beta heuristic: a user whose occupancy reached ``beta``
    times the cluster's mean scores with their OWN statistics."""
    return occ.float() >= hyper.beta * umean_occ


def mix_scores(use_own, v_own, v_clu, Minv_own, Minv_clu):
    """Per-user ``(w, minv_eff)``: own statistics where ``use_own``, the
    cluster's elsewhere."""
    w = torch.where(use_own[:, None], v_own, v_clu)
    minv_eff = torch.where(use_own[:, None, None], Minv_own, Minv_clu)
    return w, minv_eff


def cluster_rounds(be, ops, hyper, seed, step0, Minv, b, occ, budget, row0,
                   uMcinv, ubc, umean_occ):
    """Stage 3: cluster-based rounds with the beta heuristic.  The per-user
    cluster snapshots are frozen for the whole stage, so the cluster user
    vector is computed once, outside the loop."""
    v_clu = linucb.user_vector(uMcinv, ubc)

    def score_cluster(carry):
        Minv_, b_, occ_ = carry
        use_own = beta_gate(hyper, occ_, umean_occ)
        v_own = linucb.user_vector(Minv_, b_)
        return mix_scores(use_own, v_own, v_clu, Minv_, uMcinv)

    return _bandit_rounds(be, ops, hyper, seed, step0, Minv, b, occ, budget,
                          row0, score_cluster)


# ---------------------------------------------------------------------------
# stage 2: the communication stage
# ---------------------------------------------------------------------------


def stage2_comm_bytes(n: int, d: int) -> int:
    """Modeled network bytes of one stage-2 refresh: each user ships
    (M, b) into the tree reduction and the cluster stats come back
    (``2 n (d^2 + d)`` f32 words); pruning all-gathers the user vectors
    and counts (``n (d + 1)``); each of the ``ceil(log2 n) + 1`` budgeted
    CC hops exchanges the n i32 labels.  The adjacency never crosses the
    network."""
    hops = max(1, math.ceil(math.log2(max(n, 2))) + 1)
    return 4 * (2 * n * (d * d + d) + n * (d + 1) + hops * n)


def snapshot_mean_occ(seen, size, labels):
    """Cluster mean lifetime-occupancy snapshot, per user."""
    labels = labels.long()
    return seen[labels].float() / torch.clamp_min(size[labels], 1)


def connected_components(col, gb, adj, n, row0, n_local):
    """Min-label propagation over the packed local rows, with pointer
    doubling ``min(l, l[l])`` on the replicated labels; stops at the first
    hop that changes nothing, and after n hops at most."""
    labels = torch.arange(n, dtype=torch.int32, device=adj.device)
    for _ in range(n):
        local = labels[row0:row0 + n_local]
        new = col.all_gather(gb.cc_hop(adj, local, labels))
        new = torch.minimum(new, new[new.long()])
        changed = not torch.equal(new, labels)
        labels = new
        if not changed:
            break
    return labels


class Stage2Refresh(NamedTuple):
    """Everything stage 2 produces, local-slice and replicated views."""

    adj: torch.Tensor          # [n_local, words]  pruned packed rows
    labels: torch.Tensor       # [n]               replicated
    Mc: torch.Tensor           # [n, d, d]         label-indexed
    bc: torch.Tensor           # [n, d]
    size: torch.Tensor         # [n] i32
    seen: torch.Tensor         # [n] i32
    uMcinv: torch.Tensor       # [n_local, d, d]   per-user cluster snapshot
    ubc: torch.Tensor          # [n_local, d]
    umean_occ: torch.Tensor    # [n_local] f32     mean-occ snapshot
    n_clusters: torch.Tensor   # []
    comm_bytes: torch.Tensor   # [] f32            modeled bytes this refresh


def stage2_refresh(col, gb, hyper, d, Minv, b, occ, adj) -> Stage2Refresh:
    """Network update + clustering + cluster statistics.

    ``M = inv(Minv)`` is recovered once per refresh (the rounds carry only
    the inverse); the aggregation is a local ``segment_sum`` followed by
    ``col.psum``.  ``seen / size`` is the cluster's mean lifetime
    occupancy, frozen until the next refresh.
    """
    n = gb.n_cols
    n_local = Minv.shape[0]
    row0 = col.axis_index() * n_local

    # a serving session may hold Minv in bf16 (Precision.state_dtype): the
    # solves and inversions run in f32 (an f32 Minv is used as it is)
    Minv = Minv.float()
    v_local = linucb.user_vector(Minv, b)
    v_all = col.all_gather(v_local)
    occ_all = col.all_gather(occ)
    adj = gb.prune_rows(adj, v_local, occ, v_all, occ_all, hyper.gamma)
    labels = connected_components(col, gb, adj, n, row0, n_local)
    local_labels = labels[row0:row0 + n_local]

    eye = torch.eye(d, dtype=torch.float32, device=Minv.device)
    M = torch.linalg.inv(Minv)
    Mc = col.psum(segment_sum(M - eye, local_labels, n)) + eye
    bc = col.psum(segment_sum(b, local_labels, n))
    size = col.psum(segment_sum(torch.ones_like(local_labels), local_labels,
                                n))
    seen = col.psum(segment_sum(occ, local_labels, n))

    idx = local_labels.long()
    return Stage2Refresh(
        adj=adj, labels=labels, Mc=Mc, bc=bc, size=size, seen=seen,
        uMcinv=torch.linalg.inv(Mc[idx]), ubc=bc[idx],
        umean_occ=snapshot_mean_occ(seen, size, local_labels),
        n_clusters=num_clusters(labels),
        comm_bytes=torch.tensor(float(stage2_comm_bytes(n, d)),
                                dtype=torch.float32, device=Minv.device),
    )


# ---------------------------------------------------------------------------
# stage 4
# ---------------------------------------------------------------------------


def stage4_rebalance(hyper, occ, umean_occ, u_rounds, c_rounds):
    """Shift budget between personalized and cluster rounds by
    ``delta = trunc((occ - umean_occ) / 2)`` against the STAGE-2 snapshot,
    each budget clipped to ``[0, max_rounds]``."""
    delta = ((occ.float() - umean_occ) / 2.0).to(torch.int32)
    u_rounds = torch.clamp(u_rounds + delta, 0, hyper.max_rounds)
    c_rounds = torch.clamp(c_rounds - delta, 0, hyper.max_rounds)
    return u_rounds, c_rounds
