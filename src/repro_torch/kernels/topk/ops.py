"""Device dispatch for the streaming top-K: plain versions for CPU
tensors, the CUDA kernels (``csrc/topk.cu``) for CUDA tensors.  Shapes
are logical: the kernels mask ragged users, items and features, so
nothing is padded."""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from .ref import topk_ref, topk_ref_pruned

MAX_D = 64                             # csrc/topk.cu kMaxD
MAX_K = 128                            # csrc/topk.cu kMaxK
USERS_PER_BLOCK = 8                    # csrc/topk.cu kUsers
THREADS = 256                          # csrc/topk.cu kThreads
SMALL_D = 32                           # csrc/topk.cu kSmallD
_NEG_INF_ORDERED = -2139095041         # the kernel's int encoding of -inf


def _check_limits(d: int, k_short: int) -> None:
    if not 1 <= d <= MAX_D:
        raise ValueError(f"topk kernels handle 1 <= d <= {MAX_D}, got {d}")
    if not 1 <= k_short <= MAX_K:
        raise ValueError(
            f"topk kernels handle 1 <= k_short <= {MAX_K}, got {k_short}")


def chunk_items(d: int) -> int:
    """Catalog rows the unpruned kernel's block scores per chunk: four a
    thread up to d = 32 (their features in 128 registers), one above."""
    return THREADS * (4 if d <= SMALL_D else 1)


def launch_plan(groups: int, work: int, sms: int, per_sm: int) -> int:
    """Splits S per user group, each streaming every S-th of ``work``
    chunks (or tiles), for ``per_sm`` resident blocks on each of ``sms``
    SMs.  While the groups fit in one wave, as many splits as fit beside
    them (one wave, no tail); otherwise the fewest splits that make the
    grid a whole number of waves, or, where none up to ``work`` does, the
    one that fills its last wave best.  Never more splits than work, so
    every split has some."""
    slots = sms * per_sm
    work = max(work, 1)
    if groups <= slots:
        return max(1, min(work, slots // max(groups, 1)))

    def fill(s: int) -> float:
        blocks = groups * s
        return blocks / (-(-blocks // slots) * slots)

    return max(range(1, work + 1), key=lambda s: (fill(s), -s))


@functools.lru_cache(maxsize=None)
def _slots(device_index: int, d: int, k_short: int,
           pruned: bool) -> tuple[int, int]:
    """(SMs, resident blocks per SM) of the kernel that serves (d,
    k_short) on the device: ``topk_blocks_per_sm`` in csrc/topk.cu, the
    occupancy API, queried once per device and shape."""
    fn = _build.load("topk").topk_blocks_per_sm
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = fn(d, k_short, int(pruned), ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"topk occupancy query failed: CUDA error {err}, "
                           f"{blocks.value} blocks per SM")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return sms, blocks.value


def _splits(dev, groups: int, work: int, d: int, k_short: int,
            pruned: bool) -> int:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return launch_plan(groups, work, *_slots(index, d, k_short, pruned))


def _common_args(w, Minv, occ, dev, n, d):
    return [
        _build.check(w, "w", torch.float32, (n, d), dev),
        _build.check(Minv, "Minv", torch.float32, (n, d, d), dev),
        _build.check(occ, "occ", torch.int32, (n,), dev),
    ]


def topk(
    w: torch.Tensor,        # [n, d] f32
    Minv: torch.Tensor,     # [n, d, d] f32
    occ: torch.Tensor,      # [n] i32
    items: torch.Tensor,    # [N, d] f32
    live: torch.Tensor,     # [N] f32
    alpha: float,
    k_short: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores [n, k_short] f32, ids [n, k_short] i32) by (score desc, id
    asc); entries that hold no live item have score -inf."""
    dev = w.device
    if dev.type == "cpu":
        return topk_ref(w, Minv, occ, items, live, alpha, k_short)
    if dev.type != "cuda":
        raise ValueError(f"topk runs on cpu or cuda, not {dev}")
    n, d = w.shape
    N = items.shape[0]
    _check_limits(d, k_short)
    args = _common_args(w, Minv, occ, dev, n, d) + [
        _build.check(items, "items", torch.float32, (N, d), dev),
        _build.check(live, "live", torch.float32, (N,), dev),
    ]
    groups = -(-n // USERS_PER_BLOCK)
    S = _splits(dev, groups, -(-N // chunk_items(d)), d, k_short, False)
    out_s = torch.empty(n, k_short, dtype=torch.float32, device=dev)
    out_i = torch.empty(n, k_short, dtype=torch.int32, device=dev)
    part_s = torch.empty(S if S > 1 else 0, n, k_short, dtype=torch.float32,
                         device=dev)
    part_i = torch.empty(part_s.shape, dtype=torch.int32, device=dev)
    if n:
        _build.launch("topk", *args, float(alpha), n, N, d, k_short, S,
                      part_s.data_ptr(), part_i.data_ptr(),
                      out_s.data_ptr(), out_i.data_ptr())
    return out_s, out_i


def topk_pruned(
    w: torch.Tensor,        # [n, d] f32
    Minv: torch.Tensor,     # [n, d, d] f32
    occ: torch.Tensor,      # [n] i32
    items: torch.Tensor,    # [N, d] f32 cluster-sorted catalog
    live: torch.Tensor,     # [N] f32 in sorted order
    ids: torch.Tensor,      # [N] i32 global slot ids of the sorted rows
    alpha: float,
    k_short: int,
    tb: torch.Tensor,       # [n, T] tile bounds; tile = N // T
):
    """Cluster-pruned top-K: (scores, ids, tiles_skipped, tile_visits)
    with the shortlist bit-equal to :func:`topk`'s over the unsorted
    catalog.  On the card the wrapper groups users by their best-bound
    tile (8 to a block) and gives each group its bound-descending tile
    order; the skip count depends on the timing of the floors the
    kernel's splits share, the shortlist does not."""
    dev = w.device
    if dev.type == "cpu":
        return topk_ref_pruned(w, Minv, occ, items, live, ids, alpha,
                               k_short, tb)
    if dev.type != "cuda":
        raise ValueError(f"topk_pruned runs on cpu or cuda, not {dev}")
    n, d = w.shape
    N = items.shape[0]
    T = tb.shape[1]
    _check_limits(d, k_short)
    if T < 1 or N % T:
        raise ValueError(f"{N} items do not split into {T} tiles")
    _build.check(tb, "tb", torch.float32, (n, T), dev)
    order = torch.argsort(torch.argmax(tb, dim=1), stable=True)
    inv = torch.argsort(order)
    w_p, M_p, occ_p, tb_p = (a[order].contiguous() for a in (w, Minv, occ, tb))
    groups = -(-n // USERS_PER_BLOCK)
    pad = groups * USERS_PER_BLOCK - n
    tb_g = torch.cat([tb_p, tb_p.new_full((pad, T), float("-inf"))])
    tb_g = tb_g.view(groups, USERS_PER_BLOCK, T).amax(dim=1)
    tile_order = torch.argsort(-tb_g, dim=1, stable=True).to(
        torch.int32).contiguous()
    args = _common_args(w_p, M_p, occ_p, dev, n, d) + [
        _build.check(items, "items", torch.float32, (N, d), dev),
        _build.check(live, "live", torch.float32, (N,), dev),
        _build.check(ids, "ids", torch.int32, (N,), dev),
        tb_p.data_ptr(), tile_order.data_ptr(),
    ]
    S = _splits(dev, groups, T, d, k_short, True)
    gfloor = torch.full((n,), _NEG_INF_ORDERED, dtype=torch.int32,
                        device=dev)
    out_s = torch.empty(n, k_short, dtype=torch.float32, device=dev)
    out_i = torch.empty(n, k_short, dtype=torch.int32, device=dev)
    part_s = torch.empty(S if S > 1 else 0, n, k_short, dtype=torch.float32,
                         device=dev)
    part_i = torch.empty(part_s.shape, dtype=torch.int32, device=dev)
    skipped = torch.zeros(groups, S, dtype=torch.int32, device=dev)
    if n:
        _build.launch("topk_pruned", *args, gfloor.data_ptr(), float(alpha),
                      n, T, N // T, d, k_short, S, part_s.data_ptr(),
                      part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
                      skipped.data_ptr())
    return (out_s[inv], out_i[inv], int(skipped.sum()), groups * T)
