"""Device dispatch for the fused choose: plain version for CPU tensors,
the CUDA kernel (``csrc/choose.cu``) for CUDA tensors."""
from __future__ import annotations

import torch

from .. import _build
from .._build import BLOCK_RESERVED, MAX_SMEM, SM_SMEM
from .ref import choose_ref

WARP_PER_USER, REGISTER_TILE = 0, 1
TILE_MAX_D = 32                  # csrc/choose.cu kTileMaxD
TILE_THREADS = 128               # csrc/choose.cu kTileThreads
TILE_TK = 2                      # csrc/choose.cu kTK: candidates a thread
TILE_BLOCKS_PER_SM = 4           # blocks that must fit an SM at once
USERS_PER_SM = 2                 # n below this many users an SM: a block
                                 # per user, so that every SM works
# the kernel for each dtype of Minv (w, contexts and x stay f32)
KERNELS = {torch.float32: "choose", torch.bfloat16: "choose_bf16"}


def tile_smem(users: int, K: int, d: int, minv_bytes: int = 4) -> int:
    """Bytes of shared memory a register-tile block of ``users`` takes:
    Minv (``minv_bytes`` an element: 4 f32, 2 bf16), contexts and w,
    each region padded to 16 bytes with room for the copy's shift, then
    the scores, as ``csrc/choose.cu`` ``tile_bytes`` counts them."""
    def region(count, size):
        return ((count + 16 // size - 1) * size + 15) // 16 * 16
    return (region(users * d * d, minv_bytes) + region(users * K * d, 4)
            + region(users * d, 4) + 4 * (-(-users * K // 4) * 4))


def geometry(n: int, K: int, d: int, sms: int,
             minv_bytes: int = 4) -> tuple[int, int]:
    """(variant, users a block) for ``n`` users of ``K`` candidates of
    dimension ``d`` on a card of ``sms`` SMs, ``Minv`` of ``minv_bytes``
    an element.

    The register tile takes d <= 32 where a user's ceil(K / TILE_TK)
    threads fit a block of ``TILE_THREADS``.  Its users a block: as many
    as fill the block's threads, but no more than ``n / (USERS_PER_SM
    sms)`` (a block per user at serving's n = 256, so that every SM
    works) and no more than leave room for ``TILE_BLOCKS_PER_SM`` blocks
    an SM (so that some blocks copy while others compute).  Else a warp
    per user (four users a block).  Both variants pick the same
    candidate."""
    per_user = -(-K // TILE_TK)
    if (d > TILE_MAX_D or per_user > TILE_THREADS
            or tile_smem(1, K, d, minv_bytes) > MAX_SMEM):
        return WARP_PER_USER, 4
    users = max(1, min(TILE_THREADS // per_user, n // (USERS_PER_SM * sms)))
    budget = SM_SMEM // TILE_BLOCKS_PER_SM - BLOCK_RESERVED
    while users > 1 and tile_smem(users, K, d, minv_bytes) > budget:
        users -= 1
    return REGISTER_TILE, users


def choose(
    w: torch.Tensor,          # [n, d] f32
    Minv: torch.Tensor,       # [n, d, d] f32 or bf16
    contexts: torch.Tensor,   # [n, K, d] f32
    occ: torch.Tensor,        # [n] i32
    alpha: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(choice [n] i32, x [n, d]); the first index wins a tie.  A bf16
    ``Minv`` is widened (exactly) as it is read: the pick is that of
    ``Minv.float()``."""
    dev = contexts.device
    if dev.type == "cpu":
        return choose_ref(w, Minv, contexts, occ, alpha)
    if dev.type != "cuda":
        raise ValueError(f"choose runs on cpu or cuda, not {dev}")
    name = _build.minv_kernel(KERNELS, Minv, "choose")
    n, K, d = contexts.shape
    if K < 1 or d < 1:
        raise ValueError(f"choose needs K >= 1 and d >= 1, got {K=} {d=}")
    args = [
        _build.check(w, "w", torch.float32, (n, d), dev),
        _build.check(Minv, "Minv", Minv.dtype, (n, d, d), dev),
        _build.check(contexts, "contexts", torch.float32, (n, K, d), dev),
        _build.check(occ, "occ", torch.int32, (n,), dev),
    ]
    choice = torch.empty(n, dtype=torch.int32, device=dev)
    x = torch.empty(n, d, dtype=torch.float32, device=dev)
    if n:
        variant, users = geometry(n, K, d, _build.sm_count(dev.index or 0),
                                  Minv.element_size())
        _build.launch(name, *args, float(alpha), n, K, d, variant, users,
                      choice.data_ptr(), x.data_ptr())
    return choice, x
