"""Device dispatch for UCB scoring: plain version for CPU tensors, the
CUDA kernel (``csrc/ucb.cu``) for CUDA tensors."""
from __future__ import annotations

import torch

from .. import _build
from .ref import ucb_scores_ref


def ucb_scores(
    w: torch.Tensor,          # [n, d] f32
    Minv: torch.Tensor,       # [n, d, d] f32
    contexts: torch.Tensor,   # [n, K, d] f32
    occ: torch.Tensor,        # [n] i32
    alpha: float,
) -> torch.Tensor:
    """[n, K] f32 UCB scores.  Each candidate is scored by the loop the
    fused choose uses, so ``torch.argmax`` of a row picks what
    ``kernels.interact.ops.choose`` picks."""
    dev = contexts.device
    if dev.type == "cpu":
        return ucb_scores_ref(w, Minv, contexts, occ, alpha)
    if dev.type != "cuda":
        raise ValueError(f"ucb_scores runs on cpu or cuda, not {dev}")
    n, K, d = contexts.shape
    args = [
        _build.check(w, "w", torch.float32, (n, d), dev),
        _build.check(Minv, "Minv", torch.float32, (n, d, d), dev),
        _build.check(contexts, "contexts", torch.float32, (n, K, d), dev),
        _build.check(occ, "occ", torch.int32, (n,), dev),
    ]
    out = torch.empty(n, K, dtype=torch.float32, device=dev)
    if n and K:
        _build.launch("ucb", *args, float(alpha), n, K, d, out.data_ptr())
    return out
