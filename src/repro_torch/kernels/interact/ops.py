"""Device dispatch for the fused choose: plain version for CPU tensors,
the CUDA kernels for CUDA tensors.

:func:`route` picks the kernel: a bf16 ``Minv`` at ``d <= TC_MAX_D`` and
``K <= TC_MAX_K`` goes to the tensor-core filter (``FILTER``,
``csrc/choose_tc.cu``, launch count ``choose_bf16_tc``), which bounds
every candidate by an ``mma.sync`` product and rescores by the exact
chain only the candidates that can still win, so its pick is the
register tile's bit for bit; every other shape and an f32 ``Minv`` go to
``csrc/choose.cu`` (``TILE``: the register tile or the warp per user, by
:func:`geometry`).  Each filter launch counts the pairs it rescored and
its violations into ``topk.ops.FilterStats``."""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .._build import BLOCK_RESERVED, MAX_SMEM, SM_SMEM
from ..topk.ops import _record
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
TILE, FILTER = "tile", "filter"  # the two routes
FILTER_KERNEL = "choose_bf16_tc"
TC_MAX_D = 32                    # csrc/choose_tc.cu kMaxD
TC_MAX_K = 64                    # csrc/choose_tc.cu kMaxK
TC_USERS = 8                     # csrc/choose_tc.cu kUsers: users a group
TC_CHUNK = 32                    # csrc/choose_tc.cu kChunk
TC_T_STRIDE = 33                 # csrc/choose_tc.cu kTStride
TC_ENTRY = 12                    # bytes of a listed survivor (Entry)


def tile_smem(users: int, K: int, d: int, minv_bytes: int = 4) -> int:
    """Bytes of shared memory a register-tile block of ``users`` takes:
    Minv (``minv_bytes`` an element: 4 f32, 2 bf16), contexts and w,
    each region padded to 16 bytes with room for the copy's shift, then
    the scores, as ``csrc/choose.cu`` ``tile_bytes`` counts them."""
    def region(count, size):
        return ((count + 16 // size - 1) * size + 15) // 16 * 16
    return (region(users * d * d, minv_bytes) + region(users * K * d, 4)
            + region(users * d, 4) + 4 * (-(-users * K // 4) * 4))


def route(d: int, K: int, minv_dtype: torch.dtype = torch.float32) -> str:
    """The kernel that serves ``K`` candidates of width ``d`` with ``Minv``
    in ``minv_dtype``: ``FILTER`` (csrc/choose_tc.cu) for a bf16 ``Minv``
    at 1 <= d <= ``TC_MAX_D`` and 1 <= K <= ``TC_MAX_K``; ``TILE``
    (csrc/choose.cu, :func:`geometry`'s variant) for the rest."""
    filt = (minv_dtype == torch.bfloat16 and 1 <= d <= TC_MAX_D
            and 1 <= K <= TC_MAX_K)
    return FILTER if filt else TILE


def tc_smem(d: int, K: int) -> int:
    """Bytes of shared memory a filter block takes, as ``csrc/choose_tc.cu``
    ``layout`` counts them: two stages of a group's Minv (bf16, one word
    more), contexts and w, each region padded to 16 bytes with room for
    the copy's shift; then each warp's list of survivors and the rescore's
    t, and the stages' two mbarriers."""
    def region(count, size):
        return ((count + 16 // size - 1) * size + 15) // 16 * 16
    stage = (region(TC_USERS * d * d, 2) + 16 + region(TC_USERS * K * d, 4)
             + region(TC_USERS * d, 4))
    return (2 * stage + TC_ENTRY * TC_USERS * K
            + 4 * TC_USERS * TC_CHUNK * TC_T_STRIDE + 16)


@functools.lru_cache(maxsize=None)
def _tc_slots(index: int, d: int, K: int) -> int:
    """The filter's resident blocks on device ``index`` at (d, K): its SMs
    times ``choose_tc_blocks_per_sm`` (the occupancy API), queried once;
    the persistent grid is at most this many blocks."""
    fn = _build.load(FILTER_KERNEL).choose_tc_blocks_per_sm
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = fn(d, K, ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"choose filter occupancy query failed: CUDA "
                           f"error {err}, {blocks.value} blocks per SM")
    return _build.sm_count(index) * blocks.value


_FSTATS: dict = {}  # (device, grid, stream) -> the filter's counts


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


def _args(w, Minv, contexts, occ, dev, n, K, d):
    return [
        _build.check(w, "w", torch.float32, (n, d), dev),
        _build.check(Minv, "Minv", Minv.dtype, (n, d, d), dev),
        _build.check(contexts, "contexts", torch.float32, (n, K, d), dev),
        _build.check(occ, "occ", torch.int32, (n,), dev),
    ]


def choose_tc(
    w: torch.Tensor,          # [n, d] f32
    Minv: torch.Tensor,       # [n, d, d] bf16
    contexts: torch.Tensor,   # [n, K, d] f32
    occ: torch.Tensor,        # [n] i32
    alpha: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The filter kernel (``csrc/choose_tc.cu``) on CUDA tensors, whatever
    :func:`route` says: (choice [n] i32, x [n, d]), the register tile's
    pick on the same inputs bit for bit.  ``ValueError`` outside its
    limits (a bf16 ``Minv``, d <= ``TC_MAX_D``, K <= ``TC_MAX_K``)."""
    dev = contexts.device
    if dev.type != "cuda":
        raise ValueError(f"choose_tc runs on cuda, not {dev}")
    n, K, d = contexts.shape
    if route(d, K, Minv.dtype) != FILTER:
        raise ValueError(f"the choose filter takes a bf16 Minv at d <= "
                         f"{TC_MAX_D} and K <= {TC_MAX_K}, got "
                         f"{Minv.dtype}, {d=}, {K=}")
    args = _args(w, Minv, contexts, occ, dev, n, K, d)
    choice = torch.empty(n, dtype=torch.int32, device=dev)
    x = torch.empty(n, d, dtype=torch.float32, device=dev)
    if n:
        index = dev.index if dev.index is not None else \
            torch.cuda.current_device()
        grid = min(-(-n // TC_USERS), _tc_slots(index, d, K))
        # each launch writes every count before its stream reads them, so
        # one buffer serves every launch of this grid on this stream
        key = (index, grid, torch.cuda.current_stream(index).cuda_stream)
        fstats = _FSTATS.get(key)
        if fstats is None:
            fstats = _FSTATS[key] = torch.empty(
                grid, TC_USERS, 2, dtype=torch.int32, device=dev)
        _build.launch(FILTER_KERNEL, *args, float(alpha), n, K, d, grid,
                      choice.data_ptr(), x.data_ptr(), fstats.data_ptr())
        _record(fstats)
    return choice, x


def choose(
    w: torch.Tensor,          # [n, d] f32
    Minv: torch.Tensor,       # [n, d, d] f32 or bf16
    contexts: torch.Tensor,   # [n, K, d] f32
    occ: torch.Tensor,        # [n] i32
    alpha: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(choice [n] i32, x [n, d]); the first index wins a tie.  A bf16
    ``Minv`` is widened (exactly) as it is read: the pick is that of
    ``Minv.float()``.  On the card :func:`route` picks the kernel: the
    filter for a bf16 ``Minv`` within its limits, the register tile or
    the warp per user (:func:`geometry`) otherwise; all pick the same."""
    dev = contexts.device
    if dev.type == "cpu":
        return choose_ref(w, Minv, contexts, occ, alpha)
    if dev.type != "cuda":
        raise ValueError(f"choose runs on cpu or cuda, not {dev}")
    name = _build.minv_kernel(KERNELS, Minv, "choose")
    n, K, d = contexts.shape
    if K < 1 or d < 1:
        raise ValueError(f"choose needs K >= 1 and d >= 1, got {K=} {d=}")
    if route(d, K, Minv.dtype) == FILTER:
        return choose_tc(w, Minv, contexts, occ, alpha)
    args = _args(w, Minv, contexts, occ, dev, n, K, d)
    choice = torch.empty(n, dtype=torch.int32, device=dev)
    x = torch.empty(n, d, dtype=torch.float32, device=dev)
    if n:
        variant, users = geometry(n, K, d, _build.sm_count(dev.index or 0),
                                  Minv.element_size())
        _build.launch(name, *args, float(alpha), n, K, d, variant, users,
                      choice.data_ptr(), x.data_ptr())
    return choice, x
