"""Device dispatch for the rank-1 updates: plain versions for CPU
tensors, the CUDA kernels (``csrc/rank1.cu``) for CUDA tensors."""
from __future__ import annotations

import torch

from .. import _build
from .ref import rank1_update_inv_ref, rank1_update_ref

WARP_PER_USER, BLOCK_PER_USER, STAGED_SPAN = 0, 1, 2
BLOCK_PER_USER_PER_SM = 2        # a block per user: at most two an SM
BLOCK_PER_USER_MAX_D = 32        # a user's d^2 elements, <= 4 a thread
SPAN_MAX_D = 32                  # csrc/rank1.cu kSpanMaxD
SPAN_USERS = 8                   # users a block: csrc/rank1.cu kSpanWarps
SPAN_BLOCKS_PER_SM = 6           # csrc/rank1.cu kSpanMinBlocks


def span_smem(d: int, minv_bytes: int = 4) -> int:
    """Bytes of shared memory a staged-span block takes: its group of
    ``SPAN_USERS`` users' Minv (``minv_bytes`` an element), x and b, each
    region padded to 16 bytes with room for the copy's shift, then Mx, r
    and the mask of each user, as ``csrc/rank1.cu`` ``span_bytes`` counts
    them."""
    def region(count, size):
        return ((count + 16 // size - 1) * size + 15) // 16 * 16
    return (region(SPAN_USERS * d * d, minv_bytes)
            + 2 * region(SPAN_USERS * d, 4) + 4 * SPAN_USERS * 34)


def variant(n: int, d: int, sms: int) -> int:
    """The M-ful update's kernel variant for ``n`` users of dimension
    ``d`` on a card of ``sms`` SMs: a block per user (its 256 threads
    load the user's whole state in one round) for at most two blocks on
    each SM and ``d <= 32``; else a warp per user.  Both give the same
    bits for the same row."""
    if n <= BLOCK_PER_USER_PER_SM * sms and d <= BLOCK_PER_USER_MAX_D:
        return BLOCK_PER_USER
    return WARP_PER_USER


def _variant(t: torch.Tensor) -> int:
    n, d = t.shape
    return variant(n, d, _build.sm_count(t.device.index or 0))


def inv_variant(n: int, d: int, sms: int, minv_bytes: int = 4) -> int:
    """The M-free update's kernel variant: the block per user where
    ``variant`` takes it; else the staged span (a block for each group of
    ``SPAN_USERS`` consecutive users, copied and written back in 16-byte
    words) at ``d <= 32``, where a block's spans fit its shared memory;
    else a warp per user.  All give the same bits for the same row."""
    v = variant(n, d, sms)
    if (v == WARP_PER_USER and d <= SPAN_MAX_D
            and span_smem(d, minv_bytes) <= _build.MAX_SMEM):
        return STAGED_SPAN
    return v


def _state_args(Minv, b, x, r, mask):
    """The state's pointers; ``Minv`` in the dtype its kernel takes."""
    dev = Minv.device
    n, d = b.shape
    return [
        _build.check(Minv, "Minv", Minv.dtype, (n, d, d), dev),
        _build.check(b, "b", torch.float32, (n, d), dev),
        _build.check(x, "x", torch.float32, (n, d), dev),
        _build.check(r, "r", torch.float32, (n,), dev),
        _build.check(mask, "mask", torch.bool, (n,), dev),
    ]


def _on_cuda(name, t) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {t.device}")
    return True


# each update's kernel for each dtype of Minv (M, b, x, r stay f32)
KERNELS = {torch.float32: "rank1_update",
           torch.bfloat16: "rank1_update_bf16"}
INV_KERNELS = {torch.float32: "rank1_update_inv",
               torch.bfloat16: "rank1_update_inv_bf16"}


def rank1_update(
    M: torch.Tensor,      # [n, d, d] f32
    Minv: torch.Tensor,   # [n, d, d] f32 or bf16
    b: torch.Tensor,      # [n, d] f32
    x: torch.Tensor,      # [n, d] f32
    r: torch.Tensor,      # [n] f32
    mask: torch.Tensor,   # [n] bool
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(M', Minv', b') after one masked interaction per user.

    On either device ``M``, ``Minv`` and ``b`` are updated IN PLACE and
    returned.  They may be leading-dim slices of larger tensors (one
    user's row ``M[u:u+1]``): the kernel writes through the views.  A
    bf16 ``Minv`` is widened to f32 for the math and rounded back to
    nearest even (``rank1_update_bf16`` on CUDA).
    """
    if not _on_cuda("rank1_update", Minv):
        return rank1_update_ref(M, Minv, b, x, r, mask)
    name = _build.minv_kernel(KERNELS, Minv, "rank1_update")
    n, d = b.shape
    args = _state_args(Minv, b, x, r, mask)
    mp = _build.check(M, "M", torch.float32, (n, d, d), Minv.device)
    if n:
        _build.launch(name, mp, *args, n, d, _variant(b))
    return M, Minv, b


def rank1_update_inv(
    Minv: torch.Tensor,   # [n, d, d] f32 or bf16
    b: torch.Tensor,      # [n, d] f32
    x: torch.Tensor,      # [n, d] f32
    r: torch.Tensor,      # [n] f32
    mask: torch.Tensor,   # [n] bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """(Minv', b') after one masked interaction per user.

    On either device ``Minv`` and ``b`` are updated IN PLACE (by the
    kernel on CUDA, by the plain version on the CPU) and returned.  A
    bf16 ``Minv`` is widened to f32 for the math and rounded back to
    nearest even (``rank1_update_inv_bf16`` on CUDA).
    """
    if not _on_cuda("rank1_update_inv", Minv):
        return rank1_update_inv_ref(Minv, b, x, r, mask)
    name = _build.minv_kernel(INV_KERNELS, Minv, "rank1_update_inv")
    n, d = b.shape
    args = _state_args(Minv, b, x, r, mask)
    if n:
        sms = _build.sm_count(Minv.device.index or 0)
        _build.launch(name, *args, n, d,
                      inv_variant(n, d, sms, Minv.element_size()))
    return Minv, b
