"""Device dispatch for the streaming top-K: plain versions for CPU
tensors, the CUDA kernels (``csrc/topk.cu``, ``csrc/topk_tc.cu``) for
CUDA tensors.  Shapes are logical: the kernels mask ragged users, items
and features, so nothing is padded.

The catalog may be f32, bf16 or int8 with per-row f32 ``scales``
(``Precision.catalog_dtype``), and ``Minv`` f32 or bf16
(``Precision.state_dtype``); each pair of dtypes has its own kernel and
launch count (``topk``, ``topk_bf16``, ``topk_int8``, the same three
with ``minv_bf16`` after ``topk``, and the ``topk_pruned`` six), which
dequantize the items on chip as ``ref.dequantize_rows`` does and widen a
bf16 ``Minv`` (exactly) as they stage it.  ``w`` and ``occ`` stay f32
and i32.  Serving upcasts a bf16 ``Minv`` when it gathers the rows, as
``repro``'s policies do; the engines' callers may hand it over in bf16.

:func:`route` picks the kernels: bf16 and int8 items, and f32 items with
a bf16 ``Minv``, up to ``d = 32`` go to the filter kernels (``FILTER``:
the same names with ``_tc`` at the end), which bound every score by a
tensor-core product and rescore by the exact chain only the pairs that
can reach a user's floor, so their shortlist is the chain kernels' bit
for bit; f32 items with an f32 ``Minv`` and ``d > 32`` go to the chain
kernels (``CHAIN``), which score every pair.  ``chain=True``
launches the chain kernels where the filter kernels would serve: the
yardstick they are timed and checked against, not a fallback.

Each filter launch counts the pairs it rescored and its violations: a
violation is a rescored pair whose exact score exceeds its bound, which
the bound's derivation says never happens.  The count sees only the
pairs that passed the filter; a pair the filter wrongly dropped shows as
a shortlist other than the chain kernel's.  :class:`FilterStats` sums
the counts of the launches made inside its block."""
from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from .. import _build
from .ref import check_items, topk_ref, topk_ref_pruned

MAX_D = 64                             # csrc/topk.cu kMaxD
MAX_K = 128                            # csrc/topk.cu kMaxK
USERS_PER_BLOCK = 8                    # csrc/topk.cu kUsers
THREADS = 256                          # csrc/topk.cu kThreads
SMALL_D = 32                           # csrc/topk.cu kSmallD
MAX_TILES = 32                         # csrc/topk.cu kMaxTiles
TC_ROWS = 512                          # csrc/topk_tc.cu kTcRows
CHAIN, FILTER = "chain", "filter"      # the two routes
_NEG_INF_ORDERED = -2139095041         # the kernel's int encoding of -inf

# the item dtypes the kernels take, as csrc/topk.cu's ITEM template code
ITEM_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_SUFFIX = ("", "_bf16", "_int8")
# the name's part for each dtype of Minv
_MINV = {torch.float32: "", torch.bfloat16: "_minv_bf16"}


def item_kind(items: torch.Tensor, scales) -> int:
    """csrc/topk.cu's item code for ``items``: 0 f32, 1 bf16, 2 int8
    (which requires ``scales``; the other dtypes refuse them)."""
    check_items(items, scales)
    return ITEM_KINDS[items.dtype]


def route(kind: int, d: int, minv_dtype: torch.dtype = torch.float32) -> str:
    """The kernels that serve items of ``kind`` at width ``d`` with
    ``Minv`` in ``minv_dtype``: ``FILTER`` (csrc/topk_tc.cu's tensor-core
    filter kernels) for bf16 and int8 items, and f32 items with a bf16
    ``Minv`` (split into two bf16 pieces), up to ``SMALL_D``; ``CHAIN``
    (every pair scored by the chain) for f32 items with an f32 ``Minv``
    and for wider rows."""
    filt = kind in (1, 2) or (kind == 0 and minv_dtype == torch.bfloat16)
    return FILTER if filt and d <= SMALL_D else CHAIN


def kernel_name(pruned: bool, kind: int,
                minv_dtype: torch.dtype = torch.float32,
                route: str = CHAIN) -> str:
    """The ``_build`` name, and launch count, of the top-K kernel over
    items of ``kind`` with ``Minv`` in ``minv_dtype`` on ``route``;
    ``TypeError`` for a ``Minv`` dtype no kernel takes."""
    if minv_dtype not in _MINV:
        raise TypeError(f"Minv has dtype {minv_dtype}; the top-K kernels "
                        f"take {list(_MINV)}")
    if route not in (CHAIN, FILTER):
        raise ValueError(f"unknown top-K route {route!r}")
    return (("topk_pruned" if pruned else "topk") + _MINV[minv_dtype]
            + _SUFFIX[kind] + ("_tc" if route == FILTER else ""))


def _check_limits(d: int, k_short: int) -> None:
    if not 1 <= d <= MAX_D:
        raise ValueError(f"topk kernels handle 1 <= d <= {MAX_D}, got {d}")
    if not 1 <= k_short <= MAX_K:
        raise ValueError(
            f"topk kernels handle 1 <= k_short <= {MAX_K}, got {k_short}")


def chunk_items(d: int) -> int:
    """Catalog rows either chain kernel's block scores per chunk: four a
    thread up to d = 32 (their features in 128 registers), one above.
    The filter kernels' chunk is ``TC_ROWS``."""
    return THREADS * (4 if d <= SMALL_D else 1)


def tiles_per_chunk(tile: int, d: int, rows: int | None = None) -> int:
    """Tiles of ``tile`` rows the pruned kernel gathers into one chunk of
    ``rows`` (:func:`chunk_items` where not given; csrc/topk.cu
    ``tiles_per_chunk``): as many whole tiles as fit, at most
    ``MAX_TILES``; a tile longer than a chunk streams a chunk-long slice
    at a time, one tile a chunk."""
    return max(1, min(MAX_TILES, (rows or chunk_items(d)) // tile))


def pruned_chunks(T: int, tile: int, d: int, rows: int | None = None) -> int:
    """The pruned kernel's work for :func:`launch_plan`: the chunks of
    whole tiles a group's ``T`` tiles make (each split walks every S-th
    tile of its group's order, ``tiles_per_chunk`` to a chunk after a
    first chunk of one tile), before any skip."""
    return -(-T // tiles_per_chunk(tile, d, rows))


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
def _slots(device_index: int, d: int, k_short: int, pruned: bool,
           kind: int, filt: bool) -> tuple[int, int]:
    """(SMs, resident blocks per SM) of the kernel that serves (d,
    k_short) over items of ``kind`` on the device: ``topk_blocks_per_sm``
    in csrc/topk.cu (``topk_tc_blocks_per_sm`` in csrc/topk_tc.cu where
    ``filt``), the occupancy API, queried once per device and shape."""
    fn = (_build.load("topk_bf16_tc").topk_tc_blocks_per_sm
          if filt else _build.load("topk").topk_blocks_per_sm)
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = fn(d, k_short, int(pruned), kind, ctypes.byref(blocks))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"topk occupancy query failed: CUDA error {err}, "
                           f"{blocks.value} blocks per SM")
    sms = _build.sm_count(device_index)
    return sms, blocks.value


def _splits(dev, groups: int, work: int, d: int, k_short: int,
            pruned: bool, kind: int, filt: bool) -> int:
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return launch_plan(groups, work, *_slots(index, d, k_short, pruned,
                                             kind, filt))


def _fstats(groups: int, S: int, dev) -> torch.Tensor:
    """The filter kernels' counts, a (rescored, violations) pair for each
    warp of each block."""
    return torch.empty(groups, S, USERS_PER_BLOCK, 2, dtype=torch.int32,
                       device=dev)


_SINKS: list[list[torch.Tensor]] = []   # the open FilterStats blocks'


def _record(fstats) -> None:
    """A filter launch's counts into every open :class:`FilterStats`
    (one small reduction on the card while one is open, none else)."""
    if _SINKS:
        counts = fstats.view(-1, 2).sum(0, dtype=torch.int64)
        for sink in _SINKS:
            sink.append(counts)


class FilterStats(contextlib.AbstractContextManager):
    """The pairs rescored and the violations (module docstring) of every
    filter launch made inside ``with FilterStats() as st:``, in
    ``st.rescored`` and ``st.violations`` after the block."""

    def __init__(self):
        self._counts: list[torch.Tensor] = []
        self.rescored = self.violations = 0

    def __enter__(self):
        _SINKS.append(self._counts)
        return self

    def __exit__(self, *exc):
        _SINKS.remove(self._counts)
        if self._counts:
            r, v = torch.stack(self._counts).sum(0).tolist()
            self.rescored, self.violations = int(r), int(v)
        return None


def _item_args(items, live, scales, kind, dev, N, d):
    """The item operands' pointers: items in their dtype, live, and for
    int8 the scales."""
    args = [_build.check(items, "items", items.dtype, (N, d), dev),
            _build.check(live, "live", torch.float32, (N,), dev)]
    if kind == 2:
        args.append(_build.check(scales, "scales", torch.float32, (N,), dev))
    return args


def _common_args(w, Minv, occ, dev, n, d):
    """The users' pointers; ``Minv`` in the dtype its kernel takes (the
    caller has named the kernel by it)."""
    return [
        _build.check(w, "w", torch.float32, (n, d), dev),
        _build.check(Minv, "Minv", Minv.dtype, (n, d, d), dev),
        _build.check(occ, "occ", torch.int32, (n,), dev),
    ]


def topk(
    w: torch.Tensor,        # [n, d] f32
    Minv: torch.Tensor,     # [n, d, d] f32 or bf16
    occ: torch.Tensor,      # [n] i32
    items: torch.Tensor,    # [N, d] f32, bf16 or int8
    live: torch.Tensor,     # [N] f32
    alpha: float,
    k_short: int,
    *,
    scales: torch.Tensor | None = None,   # [N] f32, int8 items only
    chain: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores [n, k_short] f32, ids [n, k_short] i32) by (score desc, id
    asc); entries that hold no live item have score -inf.  Scores are
    taken on the dequantized items (``ref.dequantize_rows``).  ``chain``:
    the module's docstring (the card only)."""
    dev = w.device
    if dev.type == "cpu":
        return topk_ref(w, Minv, occ, items, live, alpha, k_short,
                        scales=scales)
    if dev.type != "cuda":
        raise ValueError(f"topk runs on cpu or cuda, not {dev}")
    n, d = w.shape
    N = items.shape[0]
    _check_limits(d, k_short)
    kind = item_kind(items, scales)
    filt = not chain and route(kind, d, Minv.dtype) == FILTER
    name = kernel_name(False, kind, Minv.dtype, FILTER if filt else CHAIN)
    args = _common_args(w, Minv, occ, dev, n, d) + _item_args(
        items, live, scales, kind, dev, N, d)
    groups = -(-n // USERS_PER_BLOCK)
    S = _splits(dev, groups, -(-N // (TC_ROWS if filt else chunk_items(d))),
                d, k_short, False, kind, filt)
    out_s = torch.empty(n, k_short, dtype=torch.float32, device=dev)
    out_i = torch.empty(n, k_short, dtype=torch.int32, device=dev)
    part_s = torch.empty(S if S > 1 else 0, n, k_short, dtype=torch.float32,
                         device=dev)
    part_i = torch.empty(part_s.shape, dtype=torch.int32, device=dev)
    fstats = _fstats(groups, S, dev) if filt else None
    if n:
        _build.launch(name, *args, float(alpha), n, N, d, k_short, S,
                      part_s.data_ptr(), part_i.data_ptr(),
                      out_s.data_ptr(), out_i.data_ptr(),
                      *([] if fstats is None else [fstats.data_ptr()]))
        if filt:
            _record(fstats)
    return out_s, out_i


def topk_pruned(
    w: torch.Tensor,        # [n, d] f32
    Minv: torch.Tensor,     # [n, d, d] f32 or bf16
    occ: torch.Tensor,      # [n] i32
    items: torch.Tensor,    # [N, d] f32/bf16/int8 cluster-sorted catalog
    live: torch.Tensor,     # [N] f32 in sorted order
    ids: torch.Tensor,      # [N] i32 global slot ids of the sorted rows
    alpha: float,
    k_short: int,
    tb: torch.Tensor,       # [n, T] tile bounds; tile = N // T
    *,
    scales: torch.Tensor | None = None,   # [N] f32 sorted, int8 only
    chain: bool = False,
):
    """Cluster-pruned top-K: (scores, ids, tiles_skipped, tile_visits)
    with the shortlist bit-equal to :func:`topk`'s over the unsorted
    catalog.  On the card the wrapper groups users by their best-bound
    tile (8 to a block) and gives each group its bound-descending tile
    order, with the group's bounds laid out in that order; the kernel
    gathers the tiles that pass its skip test into chunks
    (:func:`tiles_per_chunk`; a split's first chunk is one tile, scanned
    before the next is picked, so that its floors exist) and stages the
    next while it scores one.  The skip count depends on the timing of the floors the kernel's
    splits share, the shortlist does not.  ``chain``: the module's
    docstring (the card only)."""
    dev = w.device
    if dev.type == "cpu":
        return topk_ref_pruned(w, Minv, occ, items, live, ids, alpha,
                               k_short, tb, scales=scales)
    if dev.type != "cuda":
        raise ValueError(f"topk_pruned runs on cpu or cuda, not {dev}")
    launch, finish = pruned_launch(w, Minv, occ, items, live, ids, alpha,
                                   k_short, tb, scales=scales, chain=chain)
    launch()
    return finish()


def walk_plan(tb: torch.Tensor):
    """The pruned kernel's walk, as the plain version takes it: users in
    ``order`` (by their best-bound tile, stable), 8 to a group; each
    group's ``tile_order`` [groups, T] (by the group's largest bound,
    descending, stable); and ``tb_walk`` [groups, T, 8], the group's
    users' bounds in that order (-inf for the rows past n), so that the
    kernel reads a position's 8 bounds as two float4s.  The orders are
    int64, as the kernel reads them."""
    n, T = tb.shape
    order = torch.argsort(torch.argmax(tb, dim=1), stable=True)
    groups = -(-n // USERS_PER_BLOCK)
    pad = groups * USERS_PER_BLOCK - n
    tb_g = tb[order]
    if pad:
        tb_g = torch.cat([tb_g, tb.new_full((pad, T), float("-inf"))])
    tb_g = tb_g.view(groups, USERS_PER_BLOCK, T)
    tile_order = torch.argsort(tb_g.amax(dim=1), dim=1, descending=True,
                               stable=True)
    tb_walk = torch.gather(tb_g.transpose(1, 2), 1, tile_order[:, :, None]
                           .expand(-1, -1, USERS_PER_BLOCK))
    return order, tile_order, tb_walk


def pruned_launch(w, Minv, occ, items, live, ids, alpha, k_short, tb, *,
                  scales=None, chain=False):
    """The CUDA side of :func:`topk_pruned`, in two steps: everything up
    to the kernel's launch, then ``(launch, finish)``: ``launch()`` runs
    the kernel (and the merge), ``finish()`` returns what
    :func:`topk_pruned` returns.  ``launch`` may be called again, so that
    the kernel can be timed apart from the wrapper's work around it.  The
    kernel reads each group's users through ``order`` and writes their
    lists to their own rows, so nothing is gathered before or after."""
    dev = w.device
    n, d = w.shape
    N = items.shape[0]
    T = tb.shape[1]
    _check_limits(d, k_short)
    if T < 1 or N % T:
        raise ValueError(f"{N} items do not split into {T} tiles")
    tile = N // T
    _build.check(tb, "tb", torch.float32, (n, T), dev)
    order, tile_order, tb_walk = walk_plan(tb)
    groups = tile_order.shape[0]
    kind = item_kind(items, scales)
    filt = not chain and route(kind, d, Minv.dtype) == FILTER
    name = kernel_name(True, kind, Minv.dtype, FILTER if filt else CHAIN)
    _common_args(w, Minv, occ, dev, n, d)
    _item_args(items, live, scales, kind, dev, N, d)
    _build.check(ids, "ids", torch.int32, (N,), dev)
    S = _splits(dev, groups,
                pruned_chunks(T, tile, d, TC_ROWS if filt else None), d,
                k_short, True, kind, filt)
    item_ptrs = [t.data_ptr() for t in (items, live, ids)] + (
        [scales.data_ptr()] if kind == 2 else [])
    gfloor = torch.empty(groups * USERS_PER_BLOCK, dtype=torch.int32,
                         device=dev)
    out_s = torch.empty(n, k_short, dtype=torch.float32, device=dev)
    out_i = torch.empty(n, k_short, dtype=torch.int32, device=dev)
    part_s = torch.empty(S if S > 1 else 0, n, k_short, dtype=torch.float32,
                         device=dev)
    part_i = torch.empty(part_s.shape, dtype=torch.int32, device=dev)
    skipped = torch.empty(groups, S, dtype=torch.int32, device=dev)
    fstats = _fstats(groups, S, dev) if filt else None

    def launch():
        if not n:
            skipped.zero_()
            return
        gfloor.fill_(_NEG_INF_ORDERED)
        _build.launch(name, *(t.data_ptr() for t in (
            w, Minv, occ)), *item_ptrs, *(t.data_ptr() for t in (
                order, tb_walk, tile_order, gfloor)), float(alpha), n, T,
            tile, d, k_short, S,
            part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(),
            out_i.data_ptr(), skipped.data_ptr(),
            *([] if fstats is None else [fstats.data_ptr()]))
        if filt:
            _record(fstats)

    def finish():
        return out_s, out_i, int(skipped.sum()), groups * T

    return launch, finish
