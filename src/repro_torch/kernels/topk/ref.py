"""Plain PyTorch version of the streaming UCB top-K retrieval kernels
(``csrc/topk.cu``).

Semantics (shared with the kernels and with ``repro.kernels.topk``):

    score[u, i] = x_i . w_u + alpha sqrt(max(x_i' Minv_u x_i, 0)) sqrt(log1p(occ_u))
    shortlist_u = the ``k_short`` items with the largest scores, ordered by
                  (score desc, item id asc); dead items (``live == 0``)
                  score -inf and can only fill an underfull shortlist.

Every (user, item) pair is scored by :func:`ucb_scores_ref` of
``kernels/ucb/ref.py``: fixed-order loops of elementwise products
over ``d``, never a matrix product, whose rounding may depend on where a
row sits in its operand.  So an item's score does not depend on the tile
it is streamed in, identical items tie bit-exactly wherever they sit, and
selection by (score, id) value makes the pruned shortlist bit-equal to
the unpruned one.  The ``[n, N_items]`` score matrix is never formed: the
catalog streams through in item tiles against a running shortlist.

Cluster-pruned variant (:func:`topk_ref_pruned`): the stream is the
cluster-SORTED catalog (``core.itemclub``) and every (user, tile) pair
carries an upper bound ``tb`` (:func:`tile_bounds`).  A tile is skipped
for a row block iff STRICTLY ``tb < floor`` for every user of the block,
``floor`` being each user's running k-th score: any item of such a tile
scores below k items already found.  ``tb == floor`` must not skip (an
equal-score item with a smaller id could still displace the floor entry).

Reduced-precision catalogs (``Precision.catalog_dtype``): ``items`` may be
bf16, or int8 codes with a per-row f32 ``scales``; every score is taken on
the dequantized row ``items.float() * scales`` (:func:`dequantize_rows`,
one f32 rounding per element, as ``repro``'s ``astype(f32) * scale``), so
the semantics above hold on the dequantized catalog.
"""
from __future__ import annotations

import torch

from ..ucb.ref import ucb_scores_ref

NEG_INF = float("-inf")

# users per row block of the pruned plain version: a block skips a tile
# only when all its users agree (``repro``'s default, so skip counts match)
ROW_BLOCK = 8

# absolute margin added to every tile bound: the bound and the per-item
# score round differently, so without slack a ~1e-6 wiggle could put a
# true bound under a real score.  Scores are O(1); 1e-4 costs no pruning.
BOUND_SLACK = 1e-4


def check_items(items: torch.Tensor, scales) -> None:
    """Raise unless ``items`` is f32 or bf16 without ``scales``, or int8
    with them."""
    if items.dtype not in (torch.float32, torch.bfloat16, torch.int8):
        raise TypeError(f"items have dtype {items.dtype}; want float32, "
                        "bfloat16 or int8 with scales")
    if items.dtype == torch.int8 and scales is None:
        raise ValueError("int8 items need their per-row scales")
    if items.dtype != torch.int8 and scales is not None:
        raise ValueError(f"{items.dtype} items take no scales; only int8 "
                         "codes are scaled")


def dequantize_rows(items: torch.Tensor,
                    scales: torch.Tensor | None = None) -> torch.Tensor:
    """The f32 rows the scores are taken on: f32 as they are, bf16
    widened (exact), int8 codes times their row's f32 ``scale`` (one
    rounding).  int8 requires ``scales``; the other dtypes refuse it."""
    check_items(items, scales)
    if scales is None:
        return items.float()
    return items.float() * scales.float()[:, None]


def select_topk(buf_s: torch.Tensor, buf_i: torch.Tensor, k: int):
    """Top-``k`` of each row of ``(buf_s [n, W], buf_i [n, W])`` by
    (score desc, id asc), as ``repro.kernels.topk.ref.select_topk``:
    ``-0.0`` and ``0.0`` tie and the smaller id wins; once the finite
    entries run out, every remaining slot holds -inf and the row's
    smallest id (the reference marks each pick -inf, so by then every
    entry ties at -inf).  The result depends only on the
    (score, id) values, never on the buffer order (ids are unique among
    a row's finite entries, and ``W >= k``).  Returns
    ``(scores [n, k], ids [n, k])``."""
    if buf_s.shape[1] < k:
        raise ValueError(f"a buffer of {buf_s.shape[1]} entries has no "
                         f"top {k}")
    s = buf_s.float() + 0.0             # -0.0 -> +0.0: the sort sees values
    by_id = torch.argsort(buf_i, dim=1, stable=True)
    s, i = torch.gather(s, 1, by_id), torch.gather(buf_i, 1, by_id)
    by_s = torch.argsort(s, dim=1, descending=True, stable=True)
    s, i = torch.gather(s, 1, by_s), torch.gather(i, 1, by_s)
    s, i = s[:, :k], i[:, :k].to(torch.int32)
    smallest = buf_i.min(dim=1, keepdim=True).values.to(torch.int32)
    return s, torch.where(s == NEG_INF, smallest.expand_as(i), i)


def _scores(w, Minv, widen_occ, x, live, alpha):
    """[n, T] UCB scores of the item rows ``x [T, d]``; dead rows -inf."""
    n = w.shape[0]
    s = ucb_scores_ref(w, Minv, x.expand(n, *x.shape), widen_occ, alpha)
    return torch.where(live[None, :] > 0, s, s.new_full((), NEG_INF))


def topk_ref(
    w: torch.Tensor,        # [n, d] user score vectors
    Minv: torch.Tensor,     # [n, d, d]
    occ: torch.Tensor,      # [n] i32
    items: torch.Tensor,    # [N, d] catalog embeddings
    live: torch.Tensor,     # [N] f32 liveness (0 = retired)
    alpha: float,
    k_short: int,
    *,
    item_block: int = 4096,
    scales: torch.Tensor | None = None,   # [N] f32, int8 items only
) -> tuple[torch.Tensor, torch.Tensor]:
    """(scores [n, k_short], ids [n, k_short] i32); entries that hold no
    live item keep score -inf (the caller maps them to id -1).  Every
    user row is scored against each item tile at once: results per user
    are independent, so this row blocking changes nothing.  ``items``
    may be f32, bf16 or int8 (with ``scales``): each tile is dequantized
    by :func:`dequantize_rows` before it is scored."""
    n, d = w.shape
    N = items.shape[0]
    run_s = w.new_full((n, k_short), NEG_INF)
    run_i = torch.full((n, k_short), -1, dtype=torch.int32, device=w.device)
    # bound the [n, tile, d] intermediate of the score loops
    ib = max(1, min(item_block, 2**25 // max(1, n * d)))
    for t0 in range(0, N, ib):
        x = dequantize_rows(items[t0:t0 + ib],
                            None if scales is None else scales[t0:t0 + ib])
        s = _scores(w, Minv, occ, x, live[t0:t0 + ib], alpha)
        ids = torch.arange(t0, t0 + x.shape[0], dtype=torch.int32,
                           device=w.device)
        run_s, run_i = select_topk(torch.cat([run_s, s], 1),
                                   torch.cat([run_i, ids.expand(n, -1)], 1),
                                   k_short)
    return run_s, run_i


# ---------------------------------------------------------------------------
# cluster-pruned streaming: per-tile UCB upper bounds + tile skipping
# ---------------------------------------------------------------------------


def tile_bounds(
    w: torch.Tensor,        # [n, d] user score vectors
    Minv: torch.Tensor,     # [n, d, d] SPD
    occ: torch.Tensor,      # [n] i32
    alpha: float,
    tile_mu: torch.Tensor,  # [T, d] live-item tile centroids
    tile_r: torch.Tensor,   # [T] max live |x - mu| per tile
    tile_xn: torch.Tensor,  # [T] max live |x| per tile
    tile_n: torch.Tensor,   # [T] i32 live items per tile
) -> torch.Tensor:
    """[n, T] f32, a TRUE upper bound on every live item score per tile:

        w.x        <= w.mu + |w| r                        (Cauchy-Schwarz)
        |x|_Minv   <= min(|mu|_Minv + sqrt(lmax) r, sqrt(lmax) xn)

    so ``tb = w.mu + |w| r + alpha sqrt(log1p(occ)) min(...) + BOUND_SLACK``
    dominates ``score[u, i]`` for every live ``i`` of the tile.  Zero-live
    tiles bound to -inf.  Bounds need no fixed order: the slack covers
    their rounding."""
    n, d = w.shape
    T = tile_mu.shape[0]
    Minv = Minv.float()
    lmax = torch.linalg.eigvalsh(Minv)[:, -1]
    sl = torch.sqrt(torch.clamp_min(lmax, 0.0))
    est = w @ tile_mu.T + torch.linalg.norm(w, dim=1)[:, None] * tile_r[None]
    G = (tile_mu[:, None, :] * tile_mu[:, :, None]).reshape(T, d * d)
    qmu = torch.sqrt(torch.clamp_min(Minv.reshape(n, d * d) @ G.T, 0.0))
    conf = torch.minimum(qmu + sl[:, None] * tile_r[None],
                         sl[:, None] * tile_xn[None])
    widen = torch.sqrt(torch.log1p(occ.float()))
    tb = est + alpha * conf * widen[:, None] + BOUND_SLACK
    return torch.where(tile_n[None] > 0, tb, tb.new_full((), NEG_INF))


def _pad_rows(a: torch.Tensor, rows: int, fill=0.0) -> torch.Tensor:
    if a.shape[0] == rows:
        return a
    pad = a.new_full((rows - a.shape[0], *a.shape[1:]), fill)
    return torch.cat([a, pad])


def topk_ref_pruned(
    w: torch.Tensor,        # [n, d]
    Minv: torch.Tensor,     # [n, d, d]
    occ: torch.Tensor,      # [n] i32
    items: torch.Tensor,    # [N, d] cluster-SORTED catalog embeddings
    live: torch.Tensor,     # [N] f32 liveness in sorted order
    ids: torch.Tensor,      # [N] i32 GLOBAL slot id of each sorted row
    alpha: float,
    k_short: int,
    tb: torch.Tensor,       # [n, T] tile upper bounds (tile = N // T)
    *,
    scales: torch.Tensor | None = None,   # [N] f32 in sorted order, int8
):
    """(scores [n, k_short], ids [n, k_short], tiles_skipped, tile_visits)
    with the shortlist BIT-EQUAL to the unpruned one over the unsorted
    catalog, and the skip counts of ``repro.kernels.topk.ref
    .topk_ref_pruned``: users are grouped into row blocks by their
    best-bound tile, each block visits tiles in descending block-max bound
    order, and padded users (zero statistics, bounds -inf) vote as there.

    The blocks are independent, so they advance together: step ``j``
    takes every block's ``j``-th tile, skips it for the blocks whose users
    are all strictly below their floors and scores it for the rest in one
    batch, the same per-element arithmetic as one block at a time."""
    n, d = w.shape
    N = items.shape[0]
    T = tb.shape[1]
    if N % T:
        raise ValueError(f"{N} items do not split into {T} tiles")
    ib = N // T
    rb = min(ROW_BLOCK, n)
    nb = -(-n // rb)
    npad = nb * rb

    order = torch.argsort(torch.argmax(tb, dim=1), stable=True)
    inv = torch.argsort(order)
    w_b = _pad_rows(w[order].float(), npad).view(nb, rb, d)
    M_b = _pad_rows(Minv[order].float(), npad).view(nb, rb, d, d)
    occ_b = _pad_rows(occ[order], npad, 0).view(nb, rb)
    tb_b = _pad_rows(tb[order], npad, NEG_INF).view(nb, rb, T)
    items_t = dequantize_rows(items, scales).view(T, ib, d)
    live_t = live.view(T, ib)
    ids_t = ids.to(torch.int32).view(T, ib)
    tile_order = torch.argsort(-tb_b.amax(dim=1), dim=1, stable=True)

    run_s = w.new_full((nb, rb, k_short), NEG_INF)
    run_i = torch.full((nb, rb, k_short), -1, dtype=torch.int32,
                       device=w.device)
    skipped = 0
    for j in range(T):
        t = tile_order[:, j]                                  # [nb]
        bound = torch.gather(tb_b, 2, t[:, None, None].expand(nb, rb, 1))
        skip = torch.all(bound[..., 0] < run_s[:, :, k_short - 1], dim=1)
        act = torch.nonzero(~skip)[:, 0]                      # STRICT <
        skipped += nb - act.shape[0]
        if not act.shape[0]:
            continue
        ta, na = t[act], act.shape[0]
        x = items_t[ta][:, None].expand(na, rb, ib, d).reshape(na * rb, ib, d)
        sc = ucb_scores_ref(w_b[act].reshape(na * rb, d),
                            M_b[act].reshape(na * rb, d, d), x,
                            occ_b[act].reshape(na * rb), alpha)
        lv = live_t[ta][:, None].expand(na, rb, ib).reshape(na * rb, ib)
        sc = torch.where(lv > 0, sc, sc.new_full((), NEG_INF))
        iv = ids_t[ta][:, None].expand(na, rb, ib).reshape(na * rb, ib)
        new_s, new_i = select_topk(
            torch.cat([run_s[act].reshape(na * rb, k_short), sc], 1),
            torch.cat([run_i[act].reshape(na * rb, k_short), iv], 1),
            k_short)
        run_s[act] = new_s.view(na, rb, k_short)
        run_i[act] = new_i.view(na, rb, k_short)
    s = run_s.reshape(npad, k_short)[:n][inv]
    i = run_i.reshape(npad, k_short)[:n][inv]
    return s, i, skipped, T * nb
