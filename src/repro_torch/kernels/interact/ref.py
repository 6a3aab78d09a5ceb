"""Plain PyTorch version of the fused choose kernel (``csrc/choose.cu``).

Scores every candidate with the paper's UCB rule, takes the first-index
argmax and gathers the chosen context:

    score[u,k] = ctx[u,k].w[u]
                 + alpha sqrt(max(ctx[u,k] Minv[u] ctx[u,k], 0)) sqrt(log1p(occ[u]))

The scores are ``kernels/ucb``'s plain version, fixed-order loops over
``d`` that score identical candidate rows identically, so the first
index wins a tie.
"""
from __future__ import annotations

import torch

from ..ucb.ref import ucb_scores_ref


def choose_ref(
    w: torch.Tensor,          # [n, d]
    Minv: torch.Tensor,       # [n, d, d]
    contexts: torch.Tensor,   # [n, K, d]
    occ: torch.Tensor,        # [n] i32
    alpha: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(choice [n] i32, x [n, d]); the first index wins a tie."""
    scores = ucb_scores_ref(w, Minv, contexts, occ, alpha)
    choice = torch.argmax(scores, dim=-1).to(torch.int32)
    x = torch.take_along_dim(contexts, choice.long()[:, None, None],
                             dim=1)[:, 0]
    return choice, x


# ---------------------------------------------------------------------------
# the tensor-core filter of csrc/choose_tc.cu (a bf16 Minv, d <= 32, K <=
# 64): a plain model for the tests (the contexts' split, the product in
# each order of topk.ref.tc_sum, E, E_est, UB, LB and the survivors)
# ---------------------------------------------------------------------------

TINY = 2.0 ** -102        # a nonzero |x_j| below this: the row keeps all K


def choose_filter_ref(w, Minv, contexts, occ, alpha, *, order="forward"):
    """The filter's values for every user and candidate [n, K]: ``q``
    (q~ = sum_i x_i T_i, T = ahi M + alo M summed in ``order``), ``e``
    (e~: T_30 + T_31 at d <= 30, else sum_i x_i w_i), ``E``, ``E_est``,
    ``ub``, ``lb``, ``survive``; and ``all_survive`` [n].  The bounds are
    csrc/choose_tc.cu's (its header), computed in f64 and rounded up
    (``ub``) or down (``lb``): never looser than the kernel's, which
    rounds every step outward.  A candidate survives if !(ub < max lb);
    a user with a non-finite ub or lb, or with |M|_F or |w| past HUGE,
    keeps all K.  (The kernel rescores the survivors only where two or
    more survive: the winner survives, so a lone one is the pick.)"""
    from ..topk.ref import (ABS, E_REL_TC, HUGE, Q_REL, _down, _f64,
                            _lane_dot, _up, item_pieces, tc_sum)
    n, K, d = contexts.shape
    if Minv.dtype != torch.bfloat16 or d > 32 or K > 64:
        raise ValueError("the choose filter takes a bf16 Minv at d <= 32 "
                         "and K <= 64")
    x = torch.zeros(n, K, 32)
    x[..., :d] = contexts.float()
    ahi, alo = item_pieces(x)
    M = Minv.float()
    B = torch.zeros(n, 32, 32)               # B[u][i][j] = M[i][j]
    B[:, :d, :d] = M
    wf = w.float()
    est_tc = d <= 30
    if est_tc:                               # w's pieces at i = 30, 31
        whi = wf.bfloat16().float()
        B[:, 30, :d] = whi
        B[:, 31, :d] = (wf - whi).bfloat16().float()
    q = torch.empty(n, K)
    e = torch.empty(n, K)
    for u in range(n):
        # terms [K, i, j]: ahi's 32 k-steps, then alo's
        terms = torch.cat([ahi[u][:, None, :] * B[u][None],
                           alo[u][:, None, :] * B[u][None]], -1)
        T = tc_sum(terms, order)                       # [K, 32]
        q[u] = _lane_dot(x[u], T)
        if est_tc:
            e[u] = T[:, 30] + T[:, 31]
        else:
            wv = torch.zeros(32)
            wv[:d] = wf[u]
            e[u] = _lane_dot(x[u], wv.expand(K, 32))
    inf = float("inf")
    n2 = _up((_f64(x) ** 2).sum(-1))
    en = _up(torch.sqrt(_f64(n2)))
    tiny = ((x != 0) & (x.abs() < TINY)).any(-1)
    en2 = torch.where((n2 < HUGE) & ~tiny, n2, n2.new_full((), inf))
    F = _up(torch.sqrt(_f64(M).pow(2).flatten(1).sum(1)))
    W = _up(torch.sqrt(_f64(wf).pow(2).sum(1)))
    cM = torch.where(F < HUGE, _up(Q_REL * _f64(F) + ABS), F.new_full(
        (), inf))
    cW = torch.where(W < HUGE, _up(E_REL_TC * _f64(W) + ABS), W.new_full(
        (), inf))
    E = _up(_f64(cM)[:, None] * _f64(en2) + ABS)
    E_est = _up(_f64(cW)[:, None] * _f64(en) + ABS)
    ex = _f64(torch.sqrt(torch.log1p(occ.float())))[:, None]
    up = torch.sqrt(torch.clamp_min(_f64(q) + _f64(E), 0.0))
    down = torch.sqrt(torch.clamp_min(_f64(q) - _f64(E), 0.0))
    b_ub, b_lb = (up, down) if alpha >= 0 else (down, up)
    ub = _up(_f64(e) + _f64(E_est) + alpha * b_ub * ex)
    lb = _down(_f64(e) - _f64(E_est) + alpha * b_lb * ex)
    bad = ~torch.isfinite(q) | ~torch.isfinite(e)
    ub = torch.where(bad, ub.new_full((), float("nan")), ub)
    lb = torch.where(bad, lb.new_full((), float("nan")), lb)
    all_survive = ((~torch.isfinite(ub) | ~torch.isfinite(lb)).any(1)
                   | ~(F < HUGE) | ~(W < HUGE))
    max_lb = lb.amax(1, keepdim=True)
    survive = all_survive[:, None] | ~(ub < max_lb)
    return {"q": q, "e": e, "E": E, "E_est": E_est, "ub": ub, "lb": lb,
            "survive": survive, "all_survive": all_survive}


def choose_stress_case(seed, n, K, d, *, nonfinite=False):
    """Inputs that sit candidates at or near a user's best score, for the
    filter's tests and chip_smoke.py's checks (CPU tensors, from
    ``seed``): ``topk.ref.stress_case``'s learned (near-singular) and
    fresh bf16 Minv and w; unit contexts, and by user u % 8: (1) copies of
    one row and rows one ulp apart from it in one feature, (2) rows of
    norm 1e-3 and zero rows, (3) rows where the bonus dominates (8 x a
    fresh direction), (4) bf16-exact rows (lo piece 0) and rows one ulp
    above them, (5) one row with a feature of 2^-110 (the user keeps all
    K), (6) rows scaled 2^10, (7) a NaN row (odd users) or an inf row;
    occ 0 for every fifth user.  ``nonfinite`` adds, by user u % 16: (3)
    a NaN in Minv, (5) a NaN in w, (9) two one-hot rows of 2^70 (quad
    overflows: +inf at alpha > 0, -inf below, NaN at alpha 0), (11) the
    same at occ 0 (alpha inf 0: NaN), (13) every row one-hot 2^70.
    Returns (w, Minv, ctx, occ)."""
    from ..topk.ref import stress_case
    w, Minv, occ, _, _, _ = stress_case(seed, n, d, 32, 1, "f32",
                                        minv_dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, K, d, generator=g)
    x = x / x.norm(dim=-1, keepdim=True)
    for u in range(n):
        kind, xu = u % 8, x[u]
        pick = torch.randperm(K, generator=g)
        half = pick[:max(1, K // 2)]
        if kind == 1:
            xu[half] = xu[pick[0]].clone()
            near = pick[max(1, K // 2):]
            xu[near] = xu[pick[0]].clone()
            bits = xu[near].view(torch.int32)
            bits[:, 0] += torch.where(torch.arange(len(near)) % 2 == 0, 1,
                                      -1).to(torch.int32)
        elif kind == 2:
            xu[half] *= 1e-3
            xu[pick[-1]] = 0.0
        elif kind == 3:
            fresh = torch.randn(d, generator=g)
            xu[half] = 8 * fresh / fresh.norm()
        elif kind == 4:
            lo1 = xu[half].bfloat16().float()
            xu[half] = lo1
            xu[pick[-1]] = torch.nextafter(lo1[0], 2 * lo1[0])
        elif kind == 5:
            xu[pick[0], 0] = 2.0 ** -110
        elif kind == 6:
            xu[half] *= 2.0 ** 10
        elif kind == 7:
            xu[pick[0], -1] = float("nan") if u % 2 else float("inf")
    occ = occ.clone()
    occ[::5] = 0
    if nonfinite:
        w, Minv = w.clone(), Minv.clone()
        big = 2.0 ** 70
        Minv[3::16, 0, d - 1] = float("nan")
        w[5::16, 0] = float("nan")
        for u0, rows in ((9, {min(1, K - 1), K - 1}), (11, {0, K - 1}),
                         (13, range(K))):
            for k in rows:
                x[u0::16, k] = 0.0
                x[u0::16, k, k % d] = big
        occ[11::16] = 0
        occ[9::16] = occ[9::16].clamp_min(1)
    return w, Minv, x.contiguous(), occ
