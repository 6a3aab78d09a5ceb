"""Batched linear-contextual-bandit primitives (the per-user math).

The paper's UCB rule (Listing 1) for a context set K = [k_1..k_K]:

    estimate_j = k_j . w
    bonus_j    = alpha * sqrt(k_j^T Minv k_j) * sqrt(log(1 + occ))
    choice     = argmax_j estimate_j + bonus_j   (first index on ties)

and the rank-1 statistics update ``M += x x^T ; b += r x`` with ``Minv``
kept by Sherman-Morrison.  Everything here is batched over the leading
user axis; the hot-loop versions live in ``kernels/interact`` and
``kernels/rank1``.
"""
from __future__ import annotations

import torch

from ..kernels.interact.ref import choose_ref
from ..kernels.ucb.ref import ucb_scores_ref
from .types import LinUCBState


def init_linucb(n_users: int, d: int, device=None) -> LinUCBState:
    """Identity Gram and inverse (separate storage: Minv is updated in
    place on the card), zero b and occ."""
    eye = torch.eye(d, dtype=torch.float32, device=device)
    return LinUCBState(
        M=eye.expand(n_users, d, d).clone(),
        Minv=eye.expand(n_users, d, d).clone(),
        b=torch.zeros(n_users, d, dtype=torch.float32, device=device),
        occ=torch.zeros(n_users, dtype=torch.int32, device=device),
    )


def user_vector(Minv: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """v = Minv @ b, batched over leading axes."""
    return torch.einsum("...ij,...j->...i", Minv, b)


def ucb_scores(w, Minv, contexts, occ, alpha) -> torch.Tensor:
    """[n, K] UCB scores for a batch of users."""
    return ucb_scores_ref(w, Minv, contexts, occ, alpha)


def choose(w, Minv, contexts, occ, alpha) -> torch.Tensor:
    """[n] i32 first-index argmax of :func:`ucb_scores`."""
    return choose_ref(w, Minv, contexts, occ, alpha)[0]


def sherman_morrison(Minv: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(M + x x^T)^-1 from M^-1, for [..., d, d] and [..., d]."""
    Mx = torch.einsum("...ij,...j->...i", Minv, x)
    denom = 1.0 + torch.einsum("...i,...i->...", x, Mx)
    outer = Mx[..., :, None] * Mx[..., None, :]
    return Minv - outer / denom[..., None, None]


def masked_batch_update(
    state: LinUCBState,
    x: torch.Tensor,        # [n, d] one chosen context per user
    reward: torch.Tensor,   # [n]
    mask: torch.Tensor,     # [n] bool -- users active this step
) -> LinUCBState:
    """One interaction for every active user, in parallel (distinct users
    never alias, so a full-width masked update is exact)."""
    m = mask.to(x.dtype)
    xm = x * m[:, None]
    return LinUCBState(
        M=state.M + xm[:, :, None] * xm[:, None, :],
        Minv=sherman_morrison(state.Minv, xm),
        b=state.b + (reward * m)[:, None] * x,
        occ=state.occ + mask.to(torch.int32),
    )
