"""Plain PyTorch version of the fused choose kernel (``csrc/choose.cu``).

Scores every candidate with the paper's UCB rule, takes the first-index
argmax and gathers the chosen context:

    score[u,k] = ctx[u,k].w[u]
                 + alpha sqrt(max(ctx[u,k] Minv[u] ctx[u,k], 0)) sqrt(log1p(occ[u]))

The scores are ``kernels/ucb``'s plain version, fixed-order loops over
``d`` that score identical candidate rows identically, so the first
index wins a tie.
"""
from __future__ import annotations

import torch

from ..ucb.ref import ucb_scores_ref


def choose_ref(
    w: torch.Tensor,          # [n, d]
    Minv: torch.Tensor,       # [n, d, d]
    contexts: torch.Tensor,   # [n, K, d]
    occ: torch.Tensor,        # [n] i32
    alpha: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(choice [n] i32, x [n, d]); the first index wins a tie."""
    scores = ucb_scores_ref(w, Minv, contexts, occ, alpha)
    choice = torch.argmax(scores, dim=-1).to(torch.int32)
    x = torch.take_along_dim(contexts, choice.long()[:, None, None],
                             dim=1)[:, 0]
    return choice, x
