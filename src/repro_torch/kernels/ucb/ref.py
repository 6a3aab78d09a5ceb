"""Plain PyTorch version of the UCB scoring kernel (``csrc/ucb.cu``), and
the scoring rule every other kernel of the port holds to:

    score[u,k] = ctx[u,k].w[u]
                 + alpha sqrt(max(ctx[u,k] Minv[u] ctx[u,k], 0)) sqrt(log1p(occ[u]))

The contractions over ``d`` are written as explicit loops of elementwise
products in a fixed order, the order the kernels use, rather than as a
batched matrix product: a BLAS product may round a row differently
depending on its position in the tile, and then two identical candidate
rows no longer score identically.  Here every candidate goes through the
same operations, so identical rows give identical scores and a
first-index argmax takes the first of them (``kernels/interact``,
``kernels/topk``).
"""
from __future__ import annotations

import torch


def ucb_scores_ref(
    w: torch.Tensor,          # [n, d]
    Minv: torch.Tensor,       # [n, d, d]
    contexts: torch.Tensor,   # [n, K, d]
    occ: torch.Tensor,        # [n] i32
    alpha: float,
) -> torch.Tensor:
    """scores [n, K] (f32)."""
    d = contexts.shape[-1]
    Minv = Minv.float()
    est = torch.zeros(contexts.shape[:2], dtype=torch.float32,
                      device=contexts.device)
    t = torch.zeros_like(contexts)                 # t[u,k,i] = (Minv c)_i
    for j in range(d):
        c_j = contexts[:, :, j]                    # [n, K]
        est = est + c_j * w[:, None, j]
        t = t + Minv[:, None, :, j] * c_j[:, :, None]
    quad = torch.zeros_like(est)
    for i in range(d):
        quad = quad + contexts[:, :, i] * t[:, :, i]
    bonus = alpha * torch.sqrt(torch.clamp_min(quad, 0.0)) * torch.sqrt(
        torch.log1p(occ.float()))[:, None]
    return est + bonus
