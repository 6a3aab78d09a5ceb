"""User-graph maintenance: confidence widths, the packed graph, cluster
aggregates, and the dense oracles the tests hold the packed engine to.

The DistCLUB and CLUB drivers carry the adjacency bit-packed
(``[n, ceil(n/32)]`` int32, layout in ``kernels/graph/ref.py``) and run
stage 2 through the ``GraphBackend`` engine.  The dense ``prune_edges``
/ ``connected_components`` below materialize ``[n, n]``: numerical
oracles for small graphs, and DCCB's components at full width (its
gossip cuts single edges of a dense ``[n, n]`` bool graph).
"""
from __future__ import annotations

import torch

from ..kernels.graph import ops as graph_ops
from .types import ClusterStats, GraphState


def dense_adj(n_users: int, device=None) -> torch.Tensor:
    """[n, n] bool fully-connected adjacency minus self edges (DCCB's
    graph and the dense oracles')."""
    return ~torch.eye(n_users, dtype=torch.bool, device=device)


def init_graph(n_users: int, device=None) -> GraphState:
    """Packed fully-connected graph: [n, ceil(n/32)] int32 rows."""
    adj = graph_ops.init_packed_adj(n_users, n_users, device=device)
    return GraphState(adj=adj, labels=torch.zeros(n_users, dtype=torch.int32,
                                                  device=device))


def cb_width(occ: torch.Tensor) -> torch.Tensor:
    """CLUB's confidence-ball width around a user's estimate."""
    occf = occ.float()
    return torch.sqrt((1.0 + torch.log1p(occf)) / (1.0 + occf))


def prune_edges(adj: torch.Tensor, v: torch.Tensor, occ: torch.Tensor,
                gamma: float) -> torch.Tensor:
    """Dense oracle: drop edge (i, j) when |v_i - v_j| >= gamma (cb_i + cb_j)."""
    sq = torch.sum(v * v, dim=-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (v @ v.T)
    dist = torch.sqrt(torch.clamp_min(d2, 0.0))
    cb = cb_width(occ)
    return adj & (dist < gamma * (cb[:, None] + cb[None, :]))


def connected_components(adj: torch.Tensor) -> torch.Tensor:
    """Dense oracle: min-label propagation with pointer doubling; [n] i32
    labels, each the smallest user id of its component."""
    n = adj.shape[0]
    labels = torch.arange(n, dtype=torch.int32, device=adj.device)
    big = torch.tensor(n, dtype=torch.int32, device=adj.device)
    for _ in range(n):
        neigh = torch.where(adj, labels[None, :], big)
        l1 = torch.minimum(labels, neigh.min(dim=1).values)
        new = torch.minimum(l1, l1[l1.long()])
        if torch.equal(new, labels):
            break
        labels = new
    return labels


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """``jax.ops.segment_sum`` as an accumulating ``index_put_``.  On CUDA
    that sorts the ids (stably) and sums each segment in row order, where
    ``index_add_`` sums with atomics in an order that changes from run to
    run, and the cluster statistics would then differ in the last bit
    between two runs of the same traffic."""
    out = torch.zeros((num_segments, *data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_put_((segment_ids.long(),), data, accumulate=True)


def cluster_stats(labels: torch.Tensor, M: torch.Tensor, b: torch.Tensor,
                  d: int) -> ClusterStats:
    """Label-indexed cluster statistics: Mc = I + sum_u (Mu - I),
    bc = sum_u bu (one ridge term per cluster, as CLUB)."""
    n = labels.shape[0]
    eye = torch.eye(d, dtype=M.dtype, device=M.device)
    Mc = segment_sum(M - eye, labels, n) + eye
    return ClusterStats(
        Mc=Mc,
        # row-major: CLUB's kernels update rows of it in place (a batched
        # inverse on CUDA comes back column-major)
        Mcinv=torch.linalg.inv(Mc).contiguous(),
        bc=segment_sum(b, labels, n),
        size=segment_sum(torch.ones_like(labels), labels, n),
        seen=torch.zeros(n, dtype=torch.int32, device=labels.device),
    )


def num_clusters(labels: torch.Tensor) -> torch.Tensor:
    """Number of users that are their own label ([] i64 tensor)."""
    n = labels.shape[0]
    return torch.sum(labels == torch.arange(n, dtype=labels.dtype,
                                            device=labels.device))
