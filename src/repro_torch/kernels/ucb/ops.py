"""Device dispatch for UCB scoring: plain version for CPU tensors, the
CUDA kernels (``csrc/ucb.cu``) for CUDA tensors."""
from __future__ import annotations

import torch

from .. import _build
from .._build import MAX_SMEM
from ..interact import ops as interact_ops
from .ref import ucb_scores_ref

WARP_PER_USER, BLOCK_PER_USER, REGISTER_TILE = 0, 1, 2
# at most two blocks on each SM: rank1's crossover (kernels/rank1/ops.py),
# not measured for ucb; its one path, CLUB, runs n = 1
BLOCK_PER_USER_PER_SM = 2
BLOCK_PER_USER_MAX_D = 32        # csrc/ucb.cu kBlockMaxD
# the kernel for each dtype of Minv (w, contexts and the scores stay f32)
KERNELS = {torch.float32: "ucb", torch.bfloat16: "ucb_bf16"}


def variant(n: int, K: int, d: int, sms: int, minv_bytes: int = 4) -> int:
    """The kernel variant for ``n`` users of ``K`` candidates of dimension
    ``d`` on a card of ``sms`` SMs, ``Minv`` of ``minv_bytes`` an
    element: a block per user (its 256 threads load the user's whole
    state in one round and run the d-term chains side by side) for at
    most two blocks on each SM, ``d <= 32`` and a user's Minv, w,
    contexts and t-values within a block's shared memory; else choose's
    register tile where ``interact.ops.geometry`` takes the shape (d <=
    32, a user's ceil(K / 2) threads within a block); else a warp per
    user.  All give the same bits for the same row."""
    smem = 4 * (d * d + d + 2 * K * d)
    if (n <= BLOCK_PER_USER_PER_SM * sms and d <= BLOCK_PER_USER_MAX_D
            and smem <= MAX_SMEM):
        return BLOCK_PER_USER
    if d >= 1 and (interact_ops.geometry(n, K, d, sms, minv_bytes)[0]
                   == interact_ops.REGISTER_TILE):
        return REGISTER_TILE
    return WARP_PER_USER


def ucb_scores(
    w: torch.Tensor,          # [n, d] f32
    Minv: torch.Tensor,       # [n, d, d] f32 or bf16
    contexts: torch.Tensor,   # [n, K, d] f32
    occ: torch.Tensor,        # [n] i32
    alpha: float,
) -> torch.Tensor:
    """[n, K] f32 UCB scores.  Each candidate is scored by the loop the
    fused choose uses, so ``torch.argmax`` of a row picks what
    ``kernels.interact.ops.choose`` picks.  A bf16 ``Minv`` is widened
    (exactly) as it is read: the scores are those of ``Minv.float()``."""
    dev = contexts.device
    if dev.type == "cpu":
        return ucb_scores_ref(w, Minv, contexts, occ, alpha)
    if dev.type != "cuda":
        raise ValueError(f"ucb_scores runs on cpu or cuda, not {dev}")
    name = _build.minv_kernel(KERNELS, Minv, "ucb_scores")
    n, K, d = contexts.shape
    args = [
        _build.check(w, "w", torch.float32, (n, d), dev),
        _build.check(Minv, "Minv", Minv.dtype, (n, d, d), dev),
        _build.check(contexts, "contexts", torch.float32, (n, K, d), dev),
        _build.check(occ, "occ", torch.int32, (n,), dev),
    ]
    out = torch.empty(n, K, dtype=torch.float32, device=dev)
    if n and K:
        sms, size = _build.sm_count(dev.index or 0), Minv.element_size()
        # the tile's users a block are choose's, so ucb's blocks are its
        users = interact_ops.geometry(n, K, d, sms, size)[1]
        _build.launch(name, *args, float(alpha), n, K, d,
                      variant(n, K, d, sms, size), users, out.data_ptr())
    return out
