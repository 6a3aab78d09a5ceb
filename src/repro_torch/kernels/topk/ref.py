"""Plain PyTorch version of the streaming UCB top-K retrieval kernels
(``csrc/topk.cu``).

Semantics (shared with the kernels and with ``repro.kernels.topk``):

    score[u, i] = x_i . w_u + alpha sqrt(max(x_i' Minv_u x_i, 0)) sqrt(log1p(occ_u))
    shortlist_u = the ``k_short`` items with the largest scores, ordered by
                  (score desc, item id asc); dead items (``live == 0``)
                  score -inf and can only fill an underfull shortlist.

A NaN score on a live item takes the user's whole shortlist, as in
``repro``: its ``select_topk`` finds no entry equal to a NaN maximum, so
every slot becomes ``(NaN, INT_MAX)``, and the running list carries that
through every later tile and the merge of shards (:func:`select_topk`).
A dead item scores -inf before selection, so a NaN there changes nothing.

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
INT_MAX = 2**31 - 1        # the id of every slot of a user with a NaN score

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
    entry ties at -inf).  A row with a NaN anywhere in its buffer gives
    ``(NaN, INT_MAX)`` in every slot: the reference's maximum is NaN,
    which no entry equals.  The result depends only on the
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
    i = torch.where(s == NEG_INF, smallest.expand_as(i), i)
    return nan_rows(s, i)


def nan_rows(s: torch.Tensor, i: torch.Tensor):
    """``repro``'s ``select_topk`` fixed point on a row with a NaN score:
    every slot of it becomes ``(NaN, INT_MAX)``; the other rows are
    returned as they are."""
    bad = torch.isnan(s).any(dim=1, keepdim=True)
    return (torch.where(bad, s.new_full((), float("nan")), s),
            torch.where(bad, i.new_full((), INT_MAX), i))


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
    their rounding.  A user whose Minv is not finite (every score NaN)
    bounds every live tile by NaN, which no floor skips; ``torch``'s
    eigvalsh would raise there, and ``repro``'s returns NaN or LAPACK's
    partial values."""
    n, d = w.shape
    T = tile_mu.shape[0]
    Minv = Minv.float()
    fin = torch.isfinite(Minv).flatten(1).all(1)
    eye = torch.eye(d, dtype=Minv.dtype, device=Minv.device)
    lmax = torch.linalg.eigvalsh(torch.where(fin[:, None, None], Minv,
                                             eye))[:, -1]
    lmax = torch.where(fin, lmax, lmax.new_full((), float("nan")))
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


# ---------------------------------------------------------------------------
# the tensor-core filter of csrc/topk_tc.cu (bf16 and int8 items, and f32
# items with a bf16 Minv, d <= 32): a plain model for the tests (the
# splits, E, the bound and the pass test)
# ---------------------------------------------------------------------------

Q_REL = 2.0 ** -12        # csrc/topk_tc.cu kQRel
E_REL = 2.0 ** -15        # kERel: est from the features (d > 30)
E_REL_TC = 2.0 ** -12     # kERelTc: est from the product (d <= 30)
ABS = 2.0 ** -100         # kAbs
HUGE = 2.0 ** 60          # kHuge
FILTER_ROWS = 512         # kTcRows
# the derived relative errors (csrc/topk_tc.cu's header, d <= 32): |q~ -
# quad| <= Q_EPS s^2 A, |e~ - est| <= E_EPS(_TC) s sum |a_j| |w_j|
Q_EPS = 2.81e-5
E_EPS, E_EPS_TC = 2.63e-6, 2.56e-5
# f32 items on a bf16 Minv (the header's "f32 items"): |q~ - quad| <=
# Q_EPS_F32 A(x), |e~ - est| <= E_EPS(_TC)_F32 sum |x_j| |w_j|; their
# E_est takes E_REL_TC on both ways of forming est
Q_EPS_F32 = 4.32e-5
E_EPS_F32, E_EPS_TC_F32 = 1.78e-5, 4.09e-5
ORDERS = ("forward", "reversed", "pairwise", "truncate")


def _f64(t):
    return t.to(torch.float64)


def _up(x):
    """The least f32 >= each f64 value of ``x``."""
    y = x.to(torch.float32)
    return torch.where(_f64(y) < x, torch.nextafter(y, y.new_full(
        (), float("inf"))), y)


def _down(x):
    """The greatest f32 <= each f64 value of ``x``."""
    y = x.to(torch.float32)
    return torch.where(_f64(y) > x, torch.nextafter(y, y.new_full(
        (), float("-inf"))), y)


def fmaf_ref(a, b, c):
    """fmaf(a, b, c) of f32 tensors, exactly (one rounding of a b + c):
    the product is exact in f64, TwoSum gives the sum's exact error, and
    rounding the f64 sum to odd before rounding it to f32 gives the
    correctly rounded result (53 >= 24 + 2 bits)."""
    p = _f64(a) * _f64(b)
    cc = _f64(c)
    s = p + cc
    bb = s - p
    err = (p - (s - bb)) + (cc - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, s.new_full((), float("inf")),
                         s.new_full((), float("-inf")))
    s = torch.where((err != 0) & even & torch.isfinite(s),
                    torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def chain_ref(Minv, w, x):
    """(quad, est) [n, m] of csrc/ucb_score.cuh's chains on the widened
    rows ``x [n, m, d]``: t_i = fmaf over j from 0, quad and est fmaf over
    i from 0, in f32, exactly as the kernels run them."""
    n, m, d = x.shape
    M = Minv.float()
    quad = x.new_zeros(n, m)
    est = x.new_zeros(n, m)
    for i in range(d):
        t = x.new_zeros(n, m)
        for j in range(d):
            t = fmaf_ref(M[:, i, j, None].expand(n, m), x[:, :, j], t)
        quad = fmaf_ref(x[:, :, i], t, quad)
        est = fmaf_ref(x[:, :, i], w[:, i, None].expand(n, m), est)
    return quad, est


def item_pieces(x):
    """The filter's split of f32 rows (f32 values of bf16 pieces): ahi =
    bf16(x), alo = bf16(x - ahi); x - ahi is exact in f32, and ahi + alo
    is exact in f32, within 2^-16 |x| of x featurewise."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def minv_pieces(Minv):
    """The filter's split of Minv (f32 values of bf16 pieces): hi =
    bf16(M), lo = bf16(M - hi); M - hi is exact in f32, and a bf16 Minv
    has lo = 0."""
    M = Minv.float()
    hi = M.bfloat16().float()
    return hi, (M - hi).bfloat16().float()


def _trunc32(x):
    """Each f64 value of ``x`` truncated toward zero to f32."""
    return torch.where(x >= 0, _down(x), _up(x))


def _block_truncate(terms):
    """A sum over the last dim in 16-term steps as the header's model of
    the tensor cores has it: each step aligns its 16 products and the
    accumulator to the largest and truncates them to 24 bits, then
    truncates the sum to f32."""
    acc = terms.new_zeros(terms.shape[:-1], dtype=torch.float32)
    for k0 in range(0, terms.shape[-1], 16):
        blk = torch.cat([acc[..., None], terms[..., k0:k0 + 16]], -1)
        b64 = _f64(blk)
        big = b64.abs().amax(-1, keepdim=True)
        e = torch.floor(torch.log2(torch.where(big > 0, big,
                                               big.new_ones(()))))
        ulp = torch.exp2(e - 23)
        acc = _trunc32((torch.trunc(b64 / ulp) * ulp).sum(-1))
    return acc


def tc_sum(terms, order="forward"):
    """The f32 sum over the last dim of ``terms`` (exact products), in one
    of ``ORDERS``: forward, reversed, a pairwise tree (round to nearest),
    or the truncating 16-term steps of :func:`_block_truncate`."""
    if order == "truncate":
        return _block_truncate(terms)
    if order == "pairwise":
        t = terms.float()
        while t.shape[-1] > 1:
            if t.shape[-1] % 2:
                t = torch.cat([t, t.new_zeros(*t.shape[:-1], 1)], -1)
            t = t[..., 0::2] + t[..., 1::2]
        return t[..., 0]
    idx = range(terms.shape[-1])
    if order == "reversed":
        idx = reversed(idx)
    acc = terms.new_zeros(terms.shape[:-1], dtype=torch.float32)
    for j in idx:
        acc = acc + terms[..., j]
    return acc


def _lane_dot(a, v):
    """The epilogue's sum over 32 features of a v [..., 32]: lane t takes
    features 8 nt + 2t + {0, 1} (nt = 0 .. 3) by FMA from 0, then (t0 +
    t2) + (t1 + t3), as the shuffles combine them."""
    p = []
    for t in range(4):
        acc = a.new_zeros(a.shape[:-1])
        for nt in range(4):
            for e in range(2):
                i = 8 * nt + 2 * t + e
                acc = fmaf_ref(a[..., i], v[..., i], acc)
        p.append(acc)
    return (p[0] + p[2]) + (p[1] + p[3])


def filter_ref(w, Minv, occ, items, alpha, *, scales=None,
               order="forward"):
    """The filter kernels' per-pair values for every user and item:
    ``q`` (q~), ``e`` (e~), ``E``, ``E_est`` and ``ub`` [n, N], with the
    product's sums taken in ``order``.  ``items`` bf16, int8 codes with
    ``scales``, or f32 with a bf16 ``Minv`` (the rows split into two bf16
    pieces, both multiplied, the epilogue on their sum); d <= 32.  The
    bounds are those of csrc/topk_tc.cu's header, computed in f64 and
    rounded up: never larger than the kernel's, which rounds up at every
    step."""
    check_items(items, scales)
    n, d = w.shape
    N = items.shape[0]
    f32 = items.dtype == torch.float32
    if d > 32 or (f32 and Minv.dtype != torch.bfloat16):
        raise ValueError("the filter takes bf16 or int8 items, or f32 items "
                         "with a bf16 Minv, at d <= 32")
    x = torch.zeros(N, 32)
    x[:, :d] = items.float()                 # codes, bf16 or f32 values
    if f32:                                  # the A side's two pieces
        ahi, alo = item_pieces(x)
        a = ahi + alo                        # exact in f32
    else:
        a = x
    s = scales.float() if scales is not None else torch.ones(N)
    hi, lo = minv_pieces(Minv)
    hi = torch.nn.functional.pad(hi, (0, 32 - d, 0, 32 - d))
    lo = torch.nn.functional.pad(lo, (0, 32 - d, 0, 32 - d))
    wf = w.float()
    est_tc = d <= 30
    if est_tc:                 # w's pieces in columns 30 and 31
        whi = wf.bfloat16().float()
        hi[:, 30, :d] = whi
        hi[:, 31, :d] = (wf - whi).bfloat16().float()
    two = (lo != 0).flatten(1).any(1)
    q = torch.empty(n, N)
    e = torch.empty(n, N)
    for u in range(n):
        # terms [N, i, j]: the hi piece's K = 32, then lo's (f32 items:
        # the items' pieces against Minv's one)
        if f32:
            terms = torch.cat([ahi[:, None, :] * hi[u][None],
                               alo[:, None, :] * hi[u][None]], -1)
        else:
            th = a[:, None, :] * hi[u][None]
            terms = torch.cat([th, a[:, None, :] * lo[u][None]], -1) \
                if two[u] else th
        T = tc_sum(terms, order)                     # [N, 32]
        q[u] = _lane_dot(a, T)
        if est_tc:
            e[u] = T[:, 30] + T[:, 31]
        else:
            wv = torch.zeros(32)
            wv[:d] = wf[u]
            e[u] = _lane_dot(a, wv.expand(N, 32))
    if scales is not None:
        q = (s * s)[None] * q
        e = s[None] * e
    # the bounds' factors, rounded up (f32 items: of x itself)
    n2 = _up((_f64(x) ** 2).sum(1))
    en = _up(torch.sqrt(_f64(n2)))
    en2 = n2
    if scales is not None:
        sa = _f64(s.abs())
        en2 = _up(sa * sa * _f64(n2))
        en = _up(sa * _f64(en))
    # a subnormal feature; f32 items: one below 2^-102, whose x - ahi may
    # be nonzero below 2^-126, where the residual is not relative
    tiny = 2.0 ** -102 if f32 else 2.0 ** -126
    sub = ((x != 0) & (x.abs() < tiny)).any(1)
    en2 = torch.where((en2 < HUGE) & ~sub, en2, en2.new_full((), float(
        "inf")))
    M = Minv.float()
    F = _up(torch.sqrt(_f64(M).pow(2).flatten(1).sum(1)))
    W = _up(torch.sqrt(_f64(wf).pow(2).sum(1)))
    inf = float("inf")
    cM = torch.where(F < HUGE, _up(Q_REL * _f64(F) + ABS), F.new_full(
        (), inf))
    cW = torch.where(W < HUGE, _up((E_REL_TC if est_tc or f32 else E_REL)
                                   * _f64(W) + ABS), W.new_full((), inf))
    E = _up(_f64(cM)[:, None] * _f64(en2)[None] + ABS)
    E_est = _up(_f64(cW)[:, None] * _f64(en)[None] + ABS)
    ex = torch.sqrt(torch.log1p(occ.float()))
    eu = _f64(e) + _f64(E_est)
    if alpha >= 0:
        b = torch.sqrt(torch.clamp_min(_f64(q) + _f64(E), 0.0))
    else:
        b = torch.sqrt(torch.clamp_min(_f64(q) - _f64(E), 0.0))
    ub = _up(eu + alpha * b * _f64(ex)[:, None])
    bad = ~torch.isfinite(q) | ~torch.isfinite(e)
    ub = torch.where(bad, ub.new_full((), float("nan")), ub)
    return {"q": q, "e": e, "E": E, "E_est": E_est, "ub": ub}


def filter_stream_ref(w, Minv, occ, items, live, alpha, k_short, *,
                      scales=None, chunk=FILTER_ROWS, order="forward"):
    """The filter kernels' stream in plain PyTorch: chunks of ``chunk``
    rows; a live pair is rescored (by :func:`ucb_scores_ref`, the plain
    version's score) where ``!(ub < floor)``, the floor being the k-th
    entry of the user's list before the chunk; the rest of the chunk is
    left out.  Returns ``(scores, ids, rescored, violations)``: the
    shortlist is :func:`topk_ref`'s with ``item_block=chunk`` bit for
    bit, since no pair left out can enter; a violation is a rescored pair
    whose score exceeds its ub."""
    n, d = w.shape
    N = items.shape[0]
    f = filter_ref(w, Minv, occ, items, alpha, scales=scales, order=order)
    run_s = w.new_full((n, k_short), NEG_INF)
    run_i = torch.full((n, k_short), -1, dtype=torch.int32)
    rescored = violations = 0
    for t0 in range(0, N, chunk):
        x = dequantize_rows(items[t0:t0 + chunk],
                            None if scales is None else scales[t0:t0 + chunk])
        s = _scores(w, Minv, occ, x, live[t0:t0 + chunk], alpha)
        ub = f["ub"][:, t0:t0 + chunk]
        passed = (live[t0:t0 + chunk] > 0)[None] & ~(
            ub < run_s[:, k_short - 1:])
        rescored += int(passed.sum())
        violations += int((passed & (s > ub)).sum())
        s = torch.where(passed, s, s.new_full((), NEG_INF))
        ids = torch.arange(t0, t0 + x.shape[0], dtype=torch.int32)
        run_s, run_i = select_topk(torch.cat([run_s, s], 1),
                                   torch.cat([run_i, ids.expand(n, -1)], 1),
                                   k_short)
    return run_s, run_i, rescored, violations


def quantize_rows(x, kind):
    """f32 rows as a bank of ``kind`` ("f32", "bf16" or "int8"): (items,
    scales or None); int8 codes are round(x / s) with s = max |x_j| /
    127 a row (1 for a zero row)."""
    if kind == "f32":
        return x.clone(), None
    if kind == "bf16":
        return x.bfloat16(), None
    s = x.abs().amax(1) / 127
    s = torch.where(s > 0, s, s.new_ones(()))
    codes = torch.round(x / s[:, None]).clamp(-127, 127).to(torch.int8)
    return codes, s.float()


def stress_case(seed, n, d, N, k_short, kind, *,
                minv_dtype=torch.float32, nonfinite=None):
    """A catalog built so that many pairs sit at a user's floor, for the
    filter's tests and chip_smoke.py's checks (CPU tensors, from
    ``seed``; ``kind`` "f32", "bf16" or "int8"): users with near-singular
    Minv from hundreds of rank-1 updates along a few directions beside
    fresh ones; unit rows, rows of tiny norm, rows scaled 8x along a
    fresh direction (the bonus dominates), zero rows, dead rows; user 0's
    k-th item copied many times, and its best item copied with one
    feature (bf16, f32) or the scale (int8) one ulp apart.  f32 rows also
    stress the items' split: rows whose lo piece is zero (bf16 values),
    an ulp of x (a bf16 value one ulp up), subnormal or zero where x -
    ahi is not (features near 2^-120), rows with f32-subnormal features,
    and rows scaled 2^10.  ``nonfinite`` "users" adds non-finite scores
    after those draws: a NaN in the Minv of every 16th user from user 3,
    occ 0 for every 7th user, three live one-hot rows of 2^70 (quad
    overflows: +inf at alpha > 0, -inf below, NaN at occ 0 or alpha 0)
    and a NaN on a dead slot (int8: its scale); "items" also a live row
    with a NaN feature and one with an inf feature (int8: NaN and inf
    scales), which make every user's score NaN somewhere.  Returns (w,
    Minv, occ, items, live, scales)."""
    g = torch.Generator().manual_seed(seed)
    dirs = torch.randn(3, d, generator=g, dtype=torch.float64)
    Ms = []
    for u in range(n):
        if u % 3 == 2:                    # a fresh user
            Ms.append(torch.eye(d, dtype=torch.float64)
                      * (1 + u % 5) / 5)
            continue
        X = dirs[torch.randint(0, 3, (400,), generator=g)] + 0.05 * \
            torch.randn(400, d, generator=g, dtype=torch.float64)
        Ms.append(torch.linalg.inv(torch.eye(d, dtype=torch.float64)
                                   + X.T @ X))
    Minv = torch.stack(Ms).float()
    w = (torch.randn(n, d, generator=g) * 0.3
         + dirs[torch.randint(0, 3, (n,), generator=g)].float() * 0.2)
    occ = torch.randint(0, 500, (n,), generator=g, dtype=torch.int32)
    x = torch.randn(N, d, generator=g)
    x = x / x.norm(dim=1, keepdim=True)
    kinds = torch.randint(0, 20, (N,), generator=g)
    x[kinds == 0] *= 1e-3                                   # tiny rows
    fresh = torch.randn(d, generator=g)
    x[kinds == 1] = 8 * fresh / fresh.norm()                # bonus rows
    x[kinds == 2] = 0.0                                     # zero rows
    if kind == "f32":
        x[kinds == 3] = x[kinds == 3].bfloat16().float()    # lo = 0
        lo1 = x[kinds == 4].bfloat16().float()              # lo = ulp(x)
        x[kinds == 4] = torch.nextafter(lo1, 2 * lo1)
        x[kinds == 5] *= 2.0 ** -118                        # lo subnormal
        x[kinds == 6] *= 1e-39                              # x subnormal
        x[kinds == 7] *= 2.0 ** 10                          # large rows
    live = (torch.rand(N, generator=g) > 0.2).float()
    items, scales = quantize_rows(x, kind)
    Mq = Minv.to(minv_dtype)
    deq = dequantize_rows(items, scales)
    s0 = ucb_scores_ref(w[:1], Mq[:1], deq[None], occ[:1], 0.3)[0]
    s0 = torch.where(live > 0, s0, s0.new_full((), NEG_INF))
    order = torch.argsort(s0, descending=True, stable=True)
    kth, best = order[min(k_short, N) - 1], order[0]
    dup = torch.randperm(N, generator=g)[:max(8, N // 8)]
    items[dup] = items[kth].clone()
    if scales is not None:
        scales[dup] = scales[kth].clone()
    near = torch.randperm(N, generator=g)[:16]
    items[near] = items[best].clone()
    if kind in ("f32", "bf16"):
        ib = torch.int32 if kind == "f32" else torch.int16
        bits = items[near].view(ib)
        bits[:, 0] += torch.where(torch.arange(16) % 2 == 0, 1, -1).to(ib)
        items[near] = bits.view(items.dtype)
    else:
        up = torch.nextafter(scales[best], scales.new_full((), 1e9))
        scales[near] = torch.where(torch.arange(16) % 2 == 0, up,
                                   scales[best].clone())
    live[dup[:4]] = 0.0
    if nonfinite is not None:
        Mq, occ, items, live, scales = _nonfinite(
            g, nonfinite, Mq, occ, items, live, scales, kind)
    return w, Mq, occ, items.contiguous(), live, scales


def _nonfinite(g, which, Minv, occ, items, live, scales, kind):
    """stress_case's non-finite additions (its docstring), drawn from
    ``g`` after everything else."""
    if which not in ("users", "items"):
        raise ValueError(f"nonfinite is 'users' or 'items', not {which!r}")
    d, N = items.shape[1], items.shape[0]
    Minv, occ, items, live = (t.clone() for t in (Minv, occ, items, live))
    nan, inf = float("nan"), float("inf")
    Minv[3::16, 0, d - 1] = nan
    occ[::7] = 0
    rows = torch.randperm(N, generator=g)
    big, dead = rows[:3], rows[3]
    items[big] = 0
    cols = big % d
    live[big] = 1.0
    live[dead] = 0.0
    if kind == "int8":
        scales = scales.clone()
        items[big, cols] = 127
        scales[big] = 2.0 ** 70 / 127
        scales[dead] = nan
    else:
        items[big, cols] = 2.0 ** 70
        items[dead, 0] = nan
    if which == "items":
        live[rows[4:6]] = 1.0
        if kind == "int8":
            scales[rows[4]], scales[rows[5]] = nan, inf
        else:
            items[rows[4], d - 1] = nan
            items[rows[5], 0] = inf
    return Minv, occ, items, live, scales
