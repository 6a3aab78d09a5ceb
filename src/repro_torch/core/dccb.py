"""DCCB (Korda et al. 2016; paper Listing 2), the buffered-gossip
baseline (``repro.core.dccb``).

Structure: repeat { L lockstep interaction rounds (every user fills its
length-L FIFO buffer) ; one peer-to-peer gossip round }.

Per interaction for user j: ``w = Mw[j]^-1 bw[j]``, UCB scores with
``Mw[j]^-1``; the update ``(x x^T, r x)`` is pushed into the buffer and
the oldest entry popped into the current statistics, so the current
statistics lag the newest information by L interactions (the paper's
lazy buffer).

Gossip round (pull model; every user draws one neighbour):
    compare the local estimates (current + whole buffer);
    ``|w_i - w_peer| >= gamma (cb_i + cb_peer)`` -> cut the edge, reset
    both users; identical neighbourhoods -> average buffers and current.

As in the reference, buffer entries are full d x d matrices (gossip
averaging makes rank-2 mixtures), the graph is a dense ``[n, n]`` bool
matrix (gossip cuts single edges), and ``comm_bytes`` counts the paper's
per-exchange bytes in an f32 accumulator.  The rounds run through
``stages.interaction_rounds`` with no budget and the fused choose; the
lagged Gram is inverted batched every round.

The buffered update works IN PLACE on the state's tensors (a round
writes one slot of the ``[n, L, d, d]`` buffer, and a copy of the whole
buffer per round would cost more than the round); ``run`` owns its
state, callers that keep theirs pass a copy (:func:`clone`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from ..runtime import stages
from . import clustering, linucb
from .backend import BackendConfig
from .env_ops import EnvOps
from .types import BanditHyper, Metrics

_ENGINE = BackendConfig.create().interact()


class DCCBState(NamedTuple):
    Mw: torch.Tensor          # [n, d, d] current Gram (lagged)
    bw: torch.Tensor          # [n, d]
    Mbuf: torch.Tensor        # [n, L, d, d] FIFO of pending Gram updates
    bbuf: torch.Tensor        # [n, L, d]
    occ: torch.Tensor         # [n] i32
    adj: torch.Tensor         # [n, n] bool
    slot: int                 # ring-buffer cursor (users advance in lockstep)
    comm_bytes: torch.Tensor  # [] f32


def init_state(n_users: int, d: int, L: int, device=None) -> DCCBState:
    dev = resolve_device(device)
    eye = torch.eye(d, dtype=torch.float32, device=dev)
    return DCCBState(
        Mw=eye.expand(n_users, d, d).clone(),
        bw=torch.zeros(n_users, d, dtype=torch.float32, device=dev),
        Mbuf=torch.zeros(n_users, L, d, d, dtype=torch.float32, device=dev),
        bbuf=torch.zeros(n_users, L, d, dtype=torch.float32, device=dev),
        occ=torch.zeros(n_users, dtype=torch.int32, device=dev),
        adj=clustering.dense_adj(n_users, device=dev),
        slot=0,
        comm_bytes=torch.zeros((), dtype=torch.float32, device=dev),
    )


def clone(s: DCCBState) -> DCCBState:
    """A copy whose tensors share no storage with ``s``."""
    return DCCBState(*(v.clone() if isinstance(v, torch.Tensor) else v
                       for v in s))


def lagged_score(Mw: torch.Tensor, bw: torch.Tensor):
    """DCCB's scoring statistics from the lagged Gram: ``(w, Minv)``.
    ``Mw`` moves by buffer pops and gossip averages (rank-2 mixtures), so
    the inverse is recomputed batched, not tracked by Sherman-Morrison.
    (A batched inverse on CUDA comes back column-major; the kernels take
    row-major rows.)"""
    Minv = torch.linalg.inv(Mw).contiguous()
    return linucb.user_vector(Minv, bw), Minv


def buffered_push(s: DCCBState, x: torch.Tensor, realized: torch.Tensor,
                  mask: torch.Tensor, L: int) -> DCCBState:
    """One masked buffered interaction for every user, IN PLACE: pop the
    current slot into the current statistics, push this round's update
    into the freed slot.  Masked-off users are untouched; their pending
    entry stays buffered until their next active round pops it (push and
    pop share a slot, so no pending update is overwritten).  The cursor
    advances whatever the mask."""
    m = mask.to(x.dtype)
    xm = x * m[:, None]
    upd_M = xm[:, :, None] * xm[:, None, :]
    upd_b = (realized * m)[:, None] * xm
    old_M, old_b = s.Mbuf[:, s.slot], s.bbuf[:, s.slot]      # views
    s.Mw.add_(old_M * m[:, None, None])
    s.bw.add_(old_b * m[:, None])
    old_M.copy_(torch.where(mask[:, None, None], upd_M, old_M))
    old_b.copy_(torch.where(mask[:, None], upd_b, old_b))
    s.occ.add_(mask.to(torch.int32))
    return s._replace(slot=(s.slot + 1) % L)


def interaction_phase(state: DCCBState, ops: EnvOps, seed: int, step0: int,
                      hyper: BanditHyper, L: int):
    """L lockstep rounds, global steps ``step0 .. step0 + L - 1``; every
    user's buffer turns over once.  ``(state, Metrics [L])``."""

    def score_lagged(carry):
        return lagged_score(carry.Mw, carry.bw)

    def update_buffered(carry, t, x, realized, mask):
        return buffered_push(carry, x, realized, mask, L)

    return stages.interaction_rounds(
        _ENGINE, ops, hyper, seed, step0, state, row0=0, n_steps=L,
        occ_of=lambda s: s.occ, score_fn=score_lagged,
        update_fn=update_buffered, budget=None)


def gossip_round(state: DCCBState, peer: torch.Tensor, hyper: BanditHyper,
                 L: int, d: int) -> DCCBState:
    """One peer-to-peer exchange per user (pull model) with the drawn
    neighbours ``peer [n]`` (``EnvOps.peers_fn``); a user with no
    neighbour gossips with itself, a no-op.  Returns a new state."""
    n = state.adj.shape[0]
    ids = torch.arange(n, device=state.adj.device)
    peer = torch.where(torch.any(state.adj, dim=1), peer.long(), ids)

    # local estimates include the whole buffer
    M_local = state.Mw + torch.sum(state.Mbuf, dim=1)
    b_local = state.bw + torch.sum(state.bbuf, dim=1)
    w = torch.linalg.solve(M_local, b_local[..., None])[..., 0]

    dist = torch.linalg.norm(w - w[peer], dim=-1)
    width = clustering.cb_width(state.occ)
    other = peer != ids
    cut = (dist >= hyper.gamma * (width + width[peer])) & other

    # symmetric edge removal; resets hit both endpoints of a cut edge
    adj = state.adj.clone()
    adj[ids, peer] &= ~cut
    adj[peer, ids] &= ~cut
    hits = cut.to(torch.int32).index_add(0, peer, cut.to(torch.int32))
    reset = hits > 0

    same = (torch.all(state.adj == state.adj[peer], dim=1) & ~cut & other)

    def mix(a, init):
        shape = (n,) + (1,) * (a.ndim - 1)
        avg = torch.where(same.view(shape), 0.5 * (a + a[peer]), a)
        return torch.where(reset.view(shape), init, avg)

    eye = torch.eye(d, dtype=torch.float32, device=adj.device)
    zero = torch.zeros((), dtype=torch.float32, device=adj.device)
    # paper Fig. 3 accounting: each exchange ships buffer + active objects
    nbytes = float(n * (L + 1) * (d * d + d) * 4)
    return state._replace(
        Mw=mix(state.Mw, eye), bw=mix(state.bw, zero),
        Mbuf=mix(state.Mbuf, zero), bbuf=mix(state.bbuf, zero), adj=adj,
        comm_bytes=state.comm_bytes + torch.tensor(
            nbytes, dtype=torch.float32, device=adj.device))


def epoch(state: DCCBState, ops: EnvOps, seed: int, e: int,
          hyper: BanditHyper, d: int, L: int):
    """Epoch ``e``: rounds ``e L .. e L + L - 1``, then gossip round ``e``.
    ``(state, Metrics [L], clusters after the gossip)``."""
    state, metrics = interaction_phase(state, ops, seed, e * L, hyper, L)
    state = gossip_round(state, ops.peers_fn(seed, e, state.adj), hyper, L, d)
    n_clu = clustering.num_clusters(clustering.connected_components(
        state.adj))
    return state, metrics, n_clu


def run(ops: EnvOps, seed: int, hyper: BanditHyper, n_epochs: int, d: int,
        L: int, device=None):
    """``n_epochs`` x (L interaction rounds + one gossip round) on
    ``device`` (default ``cuda``; raises without a card unless
    ``device="cpu"``).  Returns (state, per-round Metrics
    ``[n_epochs * L]``, clusters after each gossip round ``[n_epochs]``).
    ``ops`` must produce tensors on ``device``."""
    dev = resolve_device(device)
    # f32 products in full f32 on the card (see distclub.run)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = init_state(ops.n_users, d, L, device=dev)
    per_epoch, n_clusters = [], []
    for e in range(n_epochs):
        state, metrics, n_clu = epoch(state, ops, seed, e, hyper, d, L)
        per_epoch.append(metrics)
        n_clusters.append(n_clu)
    metrics = Metrics(*(torch.cat(col) for col in zip(*per_epoch)))
    return state, metrics, torch.stack(n_clusters)
