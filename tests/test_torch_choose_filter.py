"""The choose filter on a bf16 ``Minv`` (``csrc/choose_tc.cu``,
``choose_bf16_tc``: each user's contexts split into two bf16 pieces
against its Minv's one, UB and LB of every candidate, the survivors
rescored by the exact chain) in its plain model
(``kernels/interact/ref.py`` ``choose_filter_ref``): the bounds against
the exact chain of ``csrc/ucb_score.cuh`` with the product summed in
every order of ``topk.ref.tc_sum``; the filtered pick against the
register tile's reduction over every candidate, ``choose_ref`` and
``repro``'s ``choose_pallas`` in interpret mode; non-finite users; the
route, the entry, the shared memory and the constants."""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.interact import ops as jinteract  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.interact import ops, ref  # noqa: E402
from repro_torch.kernels.topk import ref as tref  # noqa: E402

ALPHA = 0.3
BF16 = torch.bfloat16
INT_MAX = 2**31 - 1


def _chain_scores(w, Minv, ctx, occ, alpha):
    """The chain's scores [n, K] (csrc/ucb_score.cuh, exactly: t_i, est
    and quad by fmaf in its order, the bonus and the sum rounded to
    nearest), with its quad and est."""
    quad, est = tref.chain_ref(Minv, w, ctx)
    ex = torch.sqrt(torch.log1p(occ.float()))
    bonus = (alpha * torch.sqrt(torch.clamp_min(quad, 0.0))) * ex[:, None]
    return est + bonus, quad, est


def _pick_beats(s, k, bs, bk):
    """Whether (s, k) comes first in csrc/ucb_score.cuh pick_key's order:
    a NaN before every number, then the larger score, then the smaller
    k."""
    sn, bn = s != s, bs != bs
    if sn or bn:
        return sn and (not bn or k < bk)
    return s > bs or (s == bs and k < bk)


def _tile_reduce(scores, ks):
    """csrc/choose.cu's reduction of one user's (score, k) list: lane l
    takes entries l, l + 32, ... (an entry replaces its best if the lane
    has none or it comes first by pick_key's order), then
    warp_first_max, which leaves every lane the same k; lane 0's."""
    best = [float("-inf")] * 32
    best_k = [INT_MAX] * 32
    for pos, (s, k) in enumerate(zip(scores, ks)):
        lane = pos % 32
        if best_k[lane] == INT_MAX or _pick_beats(s, k, best[lane],
                                                  best_k[lane]):
            best[lane], best_k[lane] = s, k
    off = 16
    while off:
        nb, nk = list(best), list(best_k)
        for lane in range(32):
            ob, ok = best[lane ^ off], best_k[lane ^ off]
            if _pick_beats(ob, ok, best[lane], best_k[lane]):
                nb[lane], nk[lane] = ob, ok
        best, best_k = nb, nk
        off >>= 1
    assert len(set(best_k)) == 1
    return best_k[0]


def _picks(w, Minv, ctx, occ, alpha, order="forward"):
    """(the filter's pick, the register tile's pick) [n]: the filter's
    over its survivors' chain scores, the tile's over every candidate."""
    f = ref.choose_filter_ref(w, Minv, ctx, occ, alpha, order=order)
    score, _, _ = _chain_scores(w, Minv, ctx, occ, alpha)
    n, K, _ = ctx.shape
    filt, tile = [], []
    for u in range(n):
        keep = torch.nonzero(f["survive"][u])[:, 0].tolist()
        filt.append(_tile_reduce([float(score[u, k]) for k in keep], keep))
        tile.append(_tile_reduce(score[u].tolist(), list(range(K))))
    return torch.tensor(filt), torch.tensor(tile), f, score


@pytest.mark.parametrize("order", tref.ORDERS)
@pytest.mark.parametrize("d", [1, 2, 25, 30, 31, 32])
def test_bounds_hold_on_every_candidate(d, order):
    """|q~ - quad| <= E and |e~ - est| <= E_est, and LB <= the chain's
    score <= UB, for every candidate of the stress users (learned and
    fresh Minv; copies and rows one ulp apart; tiny, zero, large and
    bonus-dominated rows; rows whose lo piece is zero or an ulp), the
    product summed in ``order``; q~ also within the derived Q_EPS_F32 of
    sum |x_i| |M_ij| |x_j| and e~ within its E_EPS of sum |x_j| |w_j|.
    Where a row keeps its user's candidates (E = inf) only the pick is
    held, by the next test."""
    n, K = 16, 20
    w, Minv, ctx, occ = ref.choose_stress_case(d, n, K, d)
    f = ref.choose_filter_ref(w, Minv, ctx, occ, ALPHA, order=order)
    score, quad, est = _chain_scores(w, Minv, ctx, occ, ALPHA)
    x = ctx.double()
    A = torch.einsum("uki,uij,ukj->uk", x.abs(), Minv.double().abs(),
                     x.abs())
    Aw = torch.einsum("uki,ui->uk", x.abs(), w.double().abs())
    ok = torch.isfinite(f["E"]) & torch.isfinite(f["q"]) & \
        torch.isfinite(f["e"])
    assert int(ok.sum()) > n * K // 2
    dq = (f["q"].double() - quad.double()).abs()
    de = (f["e"].double() - est.double()).abs()
    assert bool((dq <= f["E"].double())[ok].all())
    assert bool((de <= f["E_est"].double())[ok].all())
    derived = tref.Q_EPS_F32 * A + tref.ABS * (1 + (x ** 2).sum(-1))
    assert bool((dq <= derived)[ok].all()), float((dq / derived)[ok].max())
    e_eps = tref.E_EPS_TC_F32 if d <= 30 else tref.E_EPS_F32
    assert bool((de <= e_eps * Aw + tref.ABS)[ok].all())
    fin = torch.isfinite(f["ub"]) & torch.isfinite(f["lb"])
    assert bool((f["lb"] <= score)[fin].all())
    assert bool((score <= f["ub"])[fin].all())
    assert bool((f["lb"] <= f["ub"])[fin].all())


@pytest.mark.parametrize("alpha", [-0.4, 0.0])
@pytest.mark.parametrize("d", [25, 31])
def test_bounds_with_a_negative_or_zero_alpha(alpha, d):
    """alpha < 0 swaps the roots of UB and LB, alpha = 0 leaves est's
    interval: the chain's score stays inside [LB, UB] and the filtered
    pick is the tile's."""
    w, Minv, ctx, occ = ref.choose_stress_case(7 + d, 16, 20, d)
    for order in ("forward", "truncate"):
        filt, tile, f, score = _picks(w, Minv, ctx, occ, alpha, order)
        fin = torch.isfinite(f["ub"]) & torch.isfinite(f["lb"])
        assert bool((f["lb"] <= score)[fin].all())
        assert bool((score <= f["ub"])[fin].all())
        assert torch.equal(filt, tile)


@pytest.mark.parametrize("K", [1, 2, 17, 20, 64])
@pytest.mark.parametrize("d", [1, 2, 25, 30, 31, 32])
def test_filtered_pick_is_the_tiles(K, d):
    """Over the stress users (their NaN and inf rows, ties and near-ties
    included) the filter's pick, the register tile's reduction over its
    survivors' chain scores, is the tile's over every candidate, in the
    forward and the truncating orders; at d >= 25 (unit rows at d <= 2
    tie often) most users keep few candidates."""
    n = 16
    w, Minv, ctx, occ = ref.choose_stress_case(100 * K + d, n, K, d)
    for order in ("forward", "truncate"):
        filt, tile, f, _ = _picks(w, Minv, ctx, occ, ALPHA, order)
        assert torch.equal(filt, tile)
    kept = f["survive"].sum(1)
    plain = ~f["all_survive"]
    assert bool((kept >= 1).all())
    if K >= 17 and d >= 25:
        assert float(kept[plain].float().median()) <= 2


@pytest.mark.parametrize("n,K,d", [(37, 20, 25), (24, 64, 32), (9, 7, 3),
                                   (16, 20, 31)])
def test_filtered_pick_matches_choose_ref_and_pallas(n, K, d):
    """On numpy-seeded inputs (an SPD inverse stored in bf16, unit
    contexts) the filter's pick and x = ctx[pick] equal ``choose_ref``'s
    and ``repro``'s ``choose_pallas`` (interpret mode, the same bf16
    Minv) on every row clear of a near tie, and the register tile's on
    every row; the wrapper on CPU tensors is ``choose_ref``, nothing
    launched."""
    rng = np.random.default_rng(n * 1000 + K * 10 + d)
    w = (0.3 * rng.normal(size=(n, d))).astype(np.float32)
    A = 0.1 * rng.normal(size=(n, d, d))
    M = np.linalg.inv(np.eye(d) + A @ A.transpose(0, 2, 1)).astype(
        np.float32)
    jM = jnp.asarray(M).astype(jnp.bfloat16)
    Minv = torch.from_numpy(np.array(jM.astype(jnp.float32))).to(BF16)
    ctx = rng.normal(size=(n, K, d))
    ctx = (ctx / np.linalg.norm(ctx, axis=-1, keepdims=True)).astype(
        np.float32)
    occ = rng.integers(0, 1000, n).astype(np.int32)
    t = [torch.from_numpy(w), Minv, torch.from_numpy(ctx),
         torch.from_numpy(occ)]
    filt, tile, f, score = _picks(*t, ALPHA)
    assert torch.equal(filt, tile)
    before = dict(_build.LAUNCHES)
    c, x = ops.choose(*t, ALPHA)
    assert _build.LAUNCHES == before
    jc, jx = jinteract.choose(jnp.asarray(w), jM, jnp.asarray(ctx),
                              jnp.asarray(occ), ALPHA, use_pallas=True,
                              interpret=True)
    if K > 1:
        top2 = torch.topk(score, 2, dim=-1).values
        clear = top2[:, 0] - top2[:, 1] > 1e-4
    else:
        clear = torch.ones(n, dtype=torch.bool)
    assert int(clear.sum()) >= 0.8 * n
    cl = clear.numpy()
    np.testing.assert_array_equal(filt.numpy()[cl], c.numpy()[cl])
    np.testing.assert_array_equal(filt.numpy()[cl], np.asarray(jc)[cl])
    picked = ctx[np.arange(n), filt.numpy()]
    np.testing.assert_array_equal(picked[cl], np.asarray(jx)[cl])
    np.testing.assert_array_equal(x.numpy(), ctx[np.arange(n), c.numpy()])


def test_a_non_finite_user_keeps_all_candidates():
    """A NaN or inf context row, a feature below 2^-102, a row past
    kHuge, an occ of -1 (explore NaN), |M|_F or |w| past kHuge: the
    user's candidates all survive; the users beside them keep few, a
    feature of exactly 2^-102 included."""
    n, K, d = 10, 20, 25
    rng = np.random.default_rng(5)
    ctx = rng.normal(size=(n, K, d))
    ctx = torch.from_numpy(
        (ctx / np.linalg.norm(ctx, axis=-1, keepdims=True)).astype(
            np.float32))
    A = 0.1 * rng.normal(size=(n, d, d))
    Minv = torch.from_numpy(np.linalg.inv(
        np.eye(d) + A @ A.transpose(0, 2, 1)).astype(np.float32)).to(BF16)
    w = torch.from_numpy((0.3 * rng.normal(size=(n, d))).astype(np.float32))
    occ = torch.from_numpy(rng.integers(1, 1000, n).astype(np.int32))
    ctx[0, 3, 4] = float("nan")
    ctx[1, 7, 0] = float("inf")
    ctx[2, 5, 2] = 2.0 ** -110
    ctx[3, 1] = 2.0 ** 40
    occ[4] = -1
    Minv[5, 0, 0] = 2.0 ** 70
    w[6, 1] = 2.0 ** 70
    ctx[7, 2, 3] = 2.0 ** -102
    f = ref.choose_filter_ref(w, Minv, ctx, occ, ALPHA)
    assert f["all_survive"][:7].all()
    assert bool(f["survive"][:7].all())
    assert not bool(f["all_survive"][7:].any())
    assert int(f["survive"][7:].sum()) <= 6
    filt, tile, _, _ = _picks(w, Minv, ctx, occ, ALPHA)
    assert torch.equal(filt, tile)


def test_route_picks_the_filter_for_a_bf16_minv_within_its_limits():
    """``route`` sends a bf16 Minv at 1 <= d <= 32 and 1 <= K <= 64 to the
    filter, everything else (an f32 Minv, d > 32, K > 64) to the register
    tile or the warp variant; ``choose_tc`` refuses CPU tensors and
    shapes outside its limits; the filter's entry and launch count."""
    for d in (1, 2, 25, 30, 31, 32):
        for K in (1, 2, 17, 20, 64):
            assert ops.route(d, K, BF16) == ops.FILTER
            assert ops.route(d, K, torch.float32) == ops.TILE
            assert ops.route(d, K) == ops.TILE
    for d, K in ((33, 20), (64, 20), (25, 65), (25, 256)):
        assert ops.route(d, K, BF16) == ops.TILE
    t = ref.choose_stress_case(3, 4, 20, 25)
    with pytest.raises(ValueError, match="cuda"):
        ops.choose_tc(t[0], t[1], t[2], t[3], ALPHA)
    src, entry, argtypes = _build.KERNELS[ops.FILTER_KERNEL]
    assert src == "choose_tc.cu" and entry == "choose_bf16_tc_launch"
    text = (_build.CSRC / src).read_text()
    assert f'extern "C" int {entry}(' in text
    assert 'extern "C" int choose_tc_blocks_per_sm(' in text
    # the tile's arguments up to d, then the grid, the outputs and fstats
    assert argtypes[:8] == _build.KERNELS["choose_bf16"][2][:8]
    assert argtypes[8:] == [_build._I, _build._P, _build._P, _build._P]
    assert ops.FILTER_KERNEL in _build.LAUNCHES


def _cu(name, kind=int, source="choose_tc.cu"):
    text = (_build.CSRC / source).read_text()
    if kind is int:
        return int(re.search(rf"constexpr int {name} = (\d+)\s*;",
                             text).group(1))
    m = re.search(rf"constexpr float {name} = 0x1p(-?\d+)f;", text)
    return 2.0 ** int(m.group(1))


def test_the_models_constants_are_the_kernels():
    """choose_tc.cu's bound constants are topk_tc.cu's and
    ``topk.ref``'s, its limits and layout constants the wrapper's, and
    its tiny-feature key ``ref.TINY``'s; the epilogue's error on x (its
    header) is under the f32-item sum, and kQRel covers it 8 times."""
    for name in ("kQRel", "kERelTc", "kAbs", "kHuge"):
        assert _cu(name, float) == _cu(name, float, "topk_tc.cu"), name
    assert tref.Q_REL == _cu("kQRel", float)
    assert tref.E_REL_TC == _cu("kERelTc", float)
    assert tref.ABS == _cu("kAbs", float)
    assert tref.HUGE == _cu("kHuge", float)
    assert ops.TC_USERS == _cu("kUsers")
    assert ops.TC_MAX_D == _cu("kMaxD")
    assert ops.TC_MAX_K == _cu("kMaxK")
    assert ops.TC_CHUNK == _cu("kChunk")
    assert ops.TC_T_STRIDE == _cu("kTStride")
    text = (_build.CSRC / "choose_tc.cu").read_text()
    body = text[text.index("struct Entry {"):]
    body = body[:body.index("};")]
    fields = sum(decl.count(",") + 1 for decl in re.findall(
        r"\b(?:int|float) ([^;]+);", body))
    assert 4 * fields == ops.TC_ENTRY
    key = re.search(r"kTinyKey = 2u \* (0x[0-9a-f]+)u - 2u;", text).group(1)
    assert float(np.array(int(key, 16), np.uint32).view(np.float32)) \
        == ref.TINY
    # the epilogue on x: the split once, the accumulation, the epilogue's
    # FMAs and the chain (header), under the f32-item sum it reuses
    u = 2.0 ** -24

    def g(k):
        return k * u / (1 - k * u)
    p = 1 + 2.0 ** -7 + 2.0 ** -16
    q = ((2 * g(32) + g(32) ** 2) * (1 + u) ** 2 + 2.0 ** -16
         + 68 * 2.0 ** -23 * p + g(10) * p * (1 + 1e-5))
    assert q <= 2.79e-5 < q * 1.01 and "2.79e-5" in text
    assert q <= tref.Q_EPS_F32 and tref.Q_REL >= 8 * q
    assert tref.E_REL_TC >= 4 * tref.E_EPS_TC_F32
    for v in (tref.Q_EPS_F32, tref.E_EPS_TC_F32):
        assert f"{v:.2e}".replace("e-0", "e-") in text, v


@pytest.mark.parametrize("K", [1, 20, 64])
def test_shared_memory_fits_at_every_width(K):
    """The filter's blocks fit 227 KB at every d <= 32 (``tc_smem``, the
    kernel's ``layout``), two at serving's d = 25, K = 20 beside each
    other on an SM."""
    for d in range(1, 33):
        assert ops.tc_smem(d, K) <= _build.MAX_SMEM, (d, K)
    assert ops.tc_smem(32, 64) == 205968
    assert 2 * (ops.tc_smem(25, 20) + _build.BLOCK_RESERVED) \
        <= _build.SM_SMEM
