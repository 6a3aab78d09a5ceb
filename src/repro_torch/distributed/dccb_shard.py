"""Sharded DCCB: the buffered-gossip baseline on ``torch.distributed``
(``repro.distributed.dccb_shard``).

Users are split over the ranks as in ``distclub_shard``.  An epoch is L
lockstep interaction rounds through the shared round protocol
(``stages.interaction_rounds``: the lagged-Gram score and a FIFO buffer
of rank-1 updates, any ``EnvOps``), then one gossip round.

Gossip: the paper pairs each user with a random connected peer; across
ranks that is an all-to-all.  Here, as in ``repro``, each rank sends its
users' (current + buffer) statistics one rank along the ring
(``col.permute``) and pairs user ``i`` with the arriving user ``i``; a
pair whose estimates agree within ``gamma (cb_i + cb_peer)`` averages.
The traffic is the paper's objection to DCCB, ``(L + 1)(d^2 + d)`` f32
words a user a round, and ``comm_bytes`` counts it.  The batched inverse
and solves stay library calls, as ``jnp.linalg`` stands outside any
Pallas kernel in ``repro``.

Each rank holds its rows only: ``Mw [n_local, d, d]``, ``bw``, the FIFO
``xbuf [n_local, L, d]`` and ``rbuf [n_local, L]``, ``occ``; and the
replicated ``comm_bytes``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from ..core import clustering, linucb
from ..core.backend import BackendConfig
from ..core.env_ops import EnvOps, default_synthetic_ops
from ..core.types import BanditHyper, Metrics
from ..runtime import stages
from .sharding import local_slice

_ENGINE = BackendConfig.create().interact()


class ShardedDCCB(NamedTuple):
    Mw: torch.Tensor          # [n_local, d, d] current (lagged) Gram
    bw: torch.Tensor          # [n_local, d]
    xbuf: torch.Tensor        # [n_local, L, d] FIFO of pending contexts
    rbuf: torch.Tensor        # [n_local, L]    ... and their rewards
    occ: torch.Tensor         # [n_local] i32
    comm_bytes: torch.Tensor  # [] f32 replicated


def init_state(n: int, d: int, L: int, col, device=None) -> ShardedDCCB:
    """This rank's initial shard on ``device`` (default cuda; raises
    without a card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    _, n_local = local_slice(n, col.axis_index(), col.n_shards)
    f32 = dict(dtype=torch.float32, device=dev)
    return ShardedDCCB(
        Mw=torch.eye(d, **f32).expand(n_local, d, d).clone(),
        bw=torch.zeros(n_local, d, **f32),
        xbuf=torch.zeros(n_local, L, d, **f32),
        rbuf=torch.zeros(n_local, L, **f32),
        occ=torch.zeros(n_local, dtype=torch.int32, device=dev),
        comm_bytes=torch.zeros((), **f32))


def _score_lagged(carry):
    Minv = torch.linalg.inv(carry[0]).contiguous()
    return linucb.user_vector(Minv, carry[1]), Minv


def _push(carry, slot, x, realized, mask):
    """Pop the oldest entry into the current statistics and push this
    round's in its slot, in place on the epoch's copies (lockstep: every
    user is live)."""
    Mw, bw, xbuf, rbuf, occ = carry
    x_old, r_old = xbuf[:, slot], rbuf[:, slot]
    Mw += x_old[:, :, None] * x_old[:, None, :]
    bw += r_old[:, None] * x_old
    x_old.copy_(x)
    r_old.copy_(realized)
    return Mw, bw, xbuf, rbuf, occ + 1


def build_epoch_fn(col, n: int, d: int, L: int, hyper: BanditHyper,
                   ops: EnvOps | None = None, device=None):
    """``epoch(state, seed, e) -> (state, metrics)``: rounds ``e L .. e L
    + L - 1`` (the draw schedule of ``core.dccb.epoch``), metrics
    ``[L]`` summed over the ranks, then the ring gossip."""
    dev = resolve_device(device)
    row0, _ = local_slice(n, col.axis_index(), col.n_shards)
    env = ops or default_synthetic_ops(n, d, hyper.n_candidates, device=dev)
    per_user = (L + 1) * (d * d + d) * 4.0

    def epoch(state: ShardedDCCB, seed: int, e: int):
        carry0 = (state.Mw.clone(), state.bw.clone(), state.xbuf.clone(),
                  state.rbuf.clone(), state.occ)
        (Mw, bw, xbuf, rbuf, occ), metrics = stages.interaction_rounds(
            _ENGINE, env, hyper, seed, e * L, carry0, row0=row0, n_steps=L,
            occ_of=lambda c: c[4], score_fn=_score_lagged,
            update_fn=_push, budget=None)
        metrics = Metrics(*(col.psum(v) for v in metrics))

        # one ring exchange of (current + buffer), then the merge-average
        pM, pb, pxb, prb, pocc = (col.permute(t)
                                  for t in (Mw, bw, xbuf, rbuf, occ))
        M_loc = Mw + torch.einsum("nld,nle->nde", xbuf, xbuf)
        b_loc = bw + torch.einsum("nl,nld->nd", rbuf, xbuf)
        Mp_loc = pM + torch.einsum("nld,nle->nde", pxb, pxb)
        bp_loc = pb + torch.einsum("nl,nld->nd", prb, pxb)
        w = torch.linalg.solve(M_loc, b_loc[..., None])[..., 0]
        v = torch.linalg.solve(Mp_loc, bp_loc[..., None])[..., 0]
        dist = torch.linalg.norm(w - v, dim=-1)
        width = clustering.cb_width(occ) + clustering.cb_width(pocc)
        similar = dist < hyper.gamma * width

        def mix(a, pa):
            sim = similar.view((-1,) + (1,) * (a.ndim - 1))
            return torch.where(sim, 0.5 * (a + pa), a)

        comm = state.comm_bytes + torch.tensor(
            n * per_user, dtype=torch.float32, device=dev)
        return ShardedDCCB(mix(Mw, pM), mix(bw, pb), mix(xbuf, pxb),
                           mix(rbuf, prb), occ, comm), metrics

    return epoch


def make_runtime(col, n: int, d: int, L: int, hyper: BanditHyper,
                 ops: EnvOps | None = None, device=None):
    """``(init_fn, epoch_fn)`` for this rank (``init_fn()`` its initial
    shard); ``device`` defaults to cuda and raises without a card unless
    ``device="cpu"``."""
    dev = resolve_device(device)
    epoch = build_epoch_fn(col, n, d, L, hyper, ops, dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return (lambda: init_state(n, d, L, col, dev)), epoch


def gather_state(state: ShardedDCCB, col) -> ShardedDCCB:
    """The global state on every rank, rows all-gathered in rank order."""
    return ShardedDCCB(*(col.all_gather(t) for t in state[:-1]),
                       state.comm_bytes)
