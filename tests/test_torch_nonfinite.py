"""Non-finite scores in the port's selecting plain versions against
``repro`` on the same numpy inputs: NaN and +-inf contexts, items, int8
scales, ``Minv`` and ``w``, a NaN on a dead slot, and bonuses of
``alpha * inf * 0``.

- choose: the pick is ``jnp.argmax``'s (the first NaN index where a
  score is NaN, else the first maximum), held to ``choose_pallas`` in
  interpret mode on every user, x where ``repro``'s x is ctx[choice]; the
  kept departure: the port's x is ctx[choice] where ``repro``'s one-hot
  gather spreads a NaN from a candidate it did not pick.
- top-K: ``select_topk``'s NaN fixed point ((NaN, INT_MAX) in every slot
  of a user with a NaN score on a live item), ``topk_ref`` and
  ``topk_ref_pruned`` over f32, bf16 and int8 banks on an f32 and a bf16
  ``Minv``, ``RetrievalBackend``'s shortlist ids, and one serving step
  after a NaN item is published.

Ids and the non-finite scores are held exactly; finite scores within
1e-5 (1 + |s|), as chip_smoke.py's check_topk holds them (``repro``
takes the contractions as matrix products)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import serve as jserve  # noqa: E402
from repro.core import env as jenv  # noqa: E402
from repro.core.backend import BackendConfig as JConfig  # noqa: E402
from repro.core.types import BanditHyper as JHyper  # noqa: E402
from repro.kernels.interact import ops as jinteract  # noqa: E402
from repro.kernels.topk import ref as jref  # noqa: E402
from repro.kernels.ucb import ops as jucb  # noqa: E402
from repro_torch import convert, serve  # noqa: E402
from repro_torch.core import env  # noqa: E402
from repro_torch.core.backend import BackendConfig  # noqa: E402
from repro_torch.core.types import BanditHyper  # noqa: E402
from repro_torch.kernels.interact import ref as iref  # noqa: E402
from repro_torch.kernels.topk import ref  # noqa: E402
from repro_torch.kernels.ucb import ref as uref  # noqa: E402

NAN, INF = float("nan"), float("inf")
INT_MAX = 2**31 - 1
BIG = 2.0 ** 70            # a one-hot row of this: quad overflows to +inf
BF16 = {"f32": np.float32, "bf16": jnp.bfloat16}


def _unit(a):
    return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)


def _spd_inv(rng, n, d):
    A = 0.3 * rng.normal(size=(n, d, d))
    return np.linalg.inv(np.eye(d) + A @ A.transpose(0, 2, 1)).astype(
        np.float32)


def _minv_pair(M, minv):
    """(repro's Minv, the port's) in ``minv``: bf16 as the same values."""
    jM = jnp.asarray(M).astype(BF16[minv])
    pM = torch.from_numpy(np.array(jM.astype(jnp.float32)))
    return jM, (pM.bfloat16() if minv == "bf16" else pM)


def _choose_case(K, d=6, n=12, seed=0):
    """Users by index: 0 a NaN feature in candidate min(2, K-1); 1 NaN in
    candidates 1 and 3; 2 an inf feature in candidate 0; 3 two one-hot
    rows of BIG (+inf at alpha > 0, -inf below, NaN at 0); 4 the same at
    occ 0 (alpha inf 0: NaN); 5 a NaN in Minv; 6 a NaN in w; 7 every row
    BIG (all +inf, or all -inf); 8 a -inf feature; the rest finite."""
    rng = np.random.default_rng(seed * 100 + K)
    w = (0.3 * rng.normal(size=(n, d))).astype(np.float32)
    M = _spd_inv(rng, n, d)
    ctx = _unit(rng.normal(size=(n, K, d)))
    occ = rng.integers(1, 1000, n).astype(np.int32)
    last = K - 1
    ctx[0, min(2, last), 1] = NAN
    ctx[1, min(1, last), 0] = NAN
    ctx[1, min(3, last), 4] = NAN
    ctx[2, 0, 3] = INF
    for u in (3, 4):
        for k in {min(1, last), min(4, last)}:
            ctx[u, k] = 0.0
            ctx[u, k, k % d] = BIG
    occ[4] = 0
    M[5, 0, 1] = NAN
    w[6, 2] = NAN
    ctx[7] = 0.0
    for k in range(K):
        ctx[7, k, k % d] = BIG
    ctx[8, min(1, last), 5] = -INF
    return w, M, ctx, occ


@pytest.mark.parametrize("minv", ["f32", "bf16"])
@pytest.mark.parametrize("alpha", [0.3, -0.4, 0.0])
@pytest.mark.parametrize("K", [1, 5, 8])
def test_choose_picks_like_repro_on_non_finite_scores(K, alpha, minv):
    """``choose_ref``'s pick equals ``choose_pallas``' (interpret mode) on
    every user, the NaN, +-inf and all -inf users included, and equals
    the first NaN index where a score is NaN; ``ucb_scores_ref`` is NaN
    exactly where ``repro``'s scores are; x is ctx[choice], and equals
    ``repro``'s wherever ``repro``'s x is ctx[choice]."""
    w, M, ctx, occ = _choose_case(K)
    jM, pM = _minv_pair(M, minv)
    jc, jx = jinteract.choose(jnp.asarray(w), jM, jnp.asarray(ctx),
                              jnp.asarray(occ), alpha, use_pallas=True,
                              interpret=True, block_users=16)
    tw, tctx, tocc = (torch.from_numpy(a) for a in (w, ctx, occ))
    c, x = iref.choose_ref(tw, pM, tctx, tocc, alpha)
    jc, jx = np.asarray(jc), np.asarray(jx)
    np.testing.assert_array_equal(c.numpy(), jc)
    s = uref.ucb_scores_ref(tw, pM, tctx, tocc, alpha)
    js = np.asarray(jucb.ucb_scores(jnp.asarray(w), jM, jnp.asarray(ctx),
                                    jnp.asarray(occ), alpha,
                                    use_pallas=True, interpret=True,
                                    block_users=16))
    np.testing.assert_array_equal(np.isnan(s.numpy()), np.isnan(js))
    nan = torch.isnan(s)
    first_nan = torch.argmax(nan.to(torch.int32), dim=1)
    rows = nan.any(1)
    assert bool(rows[:2].all()) and bool(rows[5:7].all())
    assert torch.equal(c[rows].long(), first_nan[rows])
    n = ctx.shape[0]
    picked = ctx[np.arange(n), jc]
    np.testing.assert_array_equal(x.numpy(), picked)
    same = np.array([np.array_equal(jx[u], picked[u], equal_nan=True)
                     for u in range(n)])
    assert same[9:].all()
    np.testing.assert_array_equal(x.numpy()[same], jx[same])


def test_choose_x_departure_is_confined_to_spread_columns():
    """The departure kept on purpose: where a candidate other than the
    pick has an inf or NaN feature, ``repro``'s one-hot gather (0 * inf =
    NaN) spreads NaN into those columns of x; the port's x is ctx[choice]
    and differs from ``repro``'s there only.  User 0: candidate 0 NaN
    (picked), candidate 2 with an inf feature; user 1: NaN candidates 1
    and 2, 1 picked; user 2: every candidate with an inf feature."""
    d, K, alpha = 4, 3, 0.3
    rng = np.random.default_rng(1)
    M = _spd_inv(rng, 3, d)
    w = (0.3 * rng.normal(size=(3, d))).astype(np.float32)
    ctx = _unit(rng.normal(size=(3, K, d)))
    ctx[0, 0, 2] = NAN
    ctx[0, 2, 1] = INF
    ctx[1, 1, 0] = NAN
    ctx[1, 2, 3] = NAN
    ctx[2, :, 0] = [INF, -INF, INF]
    occ = np.full(3, 7, np.int32)
    jc, jx = jinteract.choose(jnp.asarray(w), jnp.asarray(M),
                              jnp.asarray(ctx), jnp.asarray(occ), alpha,
                              use_pallas=True, interpret=True, block_users=8)
    c, x = iref.choose_ref(*(torch.from_numpy(a) for a in (w, M, ctx, occ)),
                           alpha)
    jc, jx = np.asarray(jc), np.asarray(jx)
    np.testing.assert_array_equal(c.numpy(), jc)
    assert jc.tolist() == [0, 1, 0]
    np.testing.assert_array_equal(x.numpy(), ctx[np.arange(3), jc])
    for u in range(3):
        others = np.delete(ctx[u], jc[u], axis=0)
        spread = (~np.isfinite(others)).any(0)
        assert spread.any()
        assert np.isnan(jx[u][spread]).all()
        np.testing.assert_array_equal(jx[u][~spread], x.numpy()[u][~spread])
    assert np.isposinf(x.numpy()[2, 0]) and np.isnan(jx[2, 0])


def test_an_inf_feature_follows_repros_reference_formula():
    """An inf feature against a Minv whose terms keep one sign scores -inf
    by the formula (``repro``'s ``choose_ref``, ``topk_ref``, the port);
    ``repro``'s Pallas kernels pad d with zero columns, where inf times 0
    makes the score NaN.  The port follows the formula, as its kernels
    run it on the logical shape: this pins the difference (ROADMAP.md,
    queue 3)."""
    d, K, alpha = 4, 3, -0.4
    M = np.broadcast_to(np.eye(d) + 0.25, (1, d, d)).astype(np.float32)
    w = np.full((1, d), 0.2, np.float32)
    w[:, 0] = -0.5
    ctx = np.random.default_rng(1).normal(size=(1, K, d)).astype(np.float32)
    ctx[0, 1] = [INF, 1.0, 1.0, 1.0]
    occ = np.full(1, 7, np.int32)
    j = [jnp.asarray(a) for a in (w, M, ctx, occ)]
    t = [torch.from_numpy(a) for a in (w, M, ctx, occ)]
    s = uref.ucb_scores_ref(*t, alpha)
    assert np.isneginf(s[0, 1].item())
    jref_c = np.asarray(jinteract.choose(*j, alpha, use_pallas=False)[0])
    jpal_c = np.asarray(jinteract.choose(*j, alpha, use_pallas=True,
                                         interpret=True, block_users=8)[0])
    c, _ = iref.choose_ref(*t, alpha)
    assert c.tolist() == jref_c.tolist() == [2] and jpal_c.tolist() == [1]
    items = np.random.default_rng(2).normal(size=(16, d)).astype(np.float32)
    items[3] = [INF, 1.0, 1.0, 1.0]
    live = np.ones(16, np.float32)
    js, ji = jref.topk_ref(j[0], j[1], j[3], jnp.asarray(items),
                           jnp.asarray(live), alpha, 4)
    ps, pi = ref.topk_ref(t[0], t[1], t[3], torch.from_numpy(items),
                          torch.from_numpy(live), alpha, 4)
    _assert_lists(ps, pi, js, ji)
    assert 3 not in pi.tolist()[0]


def test_select_topk_nan_fixed_point():
    """A NaN anywhere in a row's buffer: every slot (NaN, INT_MAX), as
    ``repro``'s repeated selection gives, whatever the buffer order; rows
    without one keep the value semantics (-inf tails with the smallest
    id)."""
    s = np.array([[0.5, NAN, 1.0, -INF, 2.0, -INF],
                  [0.5, -INF, 1.0, -INF, INF, 0.0],
                  [-INF, -INF, -INF, NAN, -INF, -INF]], np.float32)
    i = np.array([[7, 3, 9, 5, 2, 4], [1, 8, 6, 0, 4, 2],
                  [5, 6, 7, 8, 9, 10]], np.int32)
    for k in (1, 4, 6):
        want_s, want_i = (np.asarray(a) for a in jref.select_topk(
            jnp.asarray(s), jnp.asarray(i), k))
        for perm in ([0, 1, 2, 3, 4, 5], [5, 4, 3, 2, 1, 0]):
            got_s, got_i = ref.select_topk(torch.from_numpy(s[:, perm]),
                                           torch.from_numpy(i[:, perm]), k)
            np.testing.assert_array_equal(got_i.numpy(), want_i)
            np.testing.assert_array_equal(got_s.numpy(), want_s)
    assert (want_i[[0, 2]] == INT_MAX).all() and np.isnan(want_s[[0, 2]]).all()
    assert want_i[1].tolist() == [4, 6, 1, 2, 0, 0]


CASES = ["nan_item", "nan_dead", "nan_minv", "big_items", "inf_item"]


def _topk_case(case, kind, minv, n=12, d=6, N=96, seed=3):
    """Users with learned Minv (user 0 at occ 0), unit items, a quarter
    dead; then ``case``: a live item with a NaN feature (int8: a NaN
    scale); the same on a dead slot; NaN in users 2 and 5's Minv; three
    one-hot rows of BIG (+inf at alpha > 0, -inf below, NaN for user 0);
    a live item with an inf feature.  Returns repro's and the port's
    (w, Minv, occ, items, live, scales), the port's on the CPU."""
    rng = np.random.default_rng(seed)
    w = (0.3 * rng.normal(size=(n, d))).astype(np.float32)
    M = _spd_inv(rng, n, d)
    occ = rng.integers(1, 50, n).astype(np.int32)
    occ[0] = 0
    x = _unit(rng.normal(size=(N, d)))
    live = (rng.random(N) > 0.25).astype(np.float32)
    live[[17, 40, 41]] = [1.0, 0.0, 1.0]
    if case == "big_items":
        for r in (3, 41, 77):
            x[r] = 0.0
            x[r, r % d] = BIG
            live[r] = 1.0
    if case == "nan_minv":
        M[2, 0, 1] = NAN
        M[5, 3, 3] = NAN
    scales = None
    if kind == "int8":
        s = np.abs(x).max(1) / 127
        s = np.where(s > 0, s, 1).astype(np.float32)
        codes = np.clip(np.round(x / s[:, None]), -127, 127).astype(np.int8)
        jitems, scales = jnp.asarray(codes), s
        if case in ("nan_item", "nan_dead"):
            scales[17 if case == "nan_item" else 40] = NAN
        if case == "inf_item":
            scales[41] = INF
        pitems = torch.from_numpy(codes)
    else:
        if case in ("nan_item", "nan_dead"):
            x[17 if case == "nan_item" else 40, 1] = NAN
        if case == "inf_item":
            x[41, 2] = INF
        jitems = jnp.asarray(x).astype(BF16[kind])
        pitems = torch.from_numpy(np.array(jitems.astype(jnp.float32)))
        if kind == "bf16":
            pitems = pitems.bfloat16()
    jM, pM = _minv_pair(M, minv)
    j = (jnp.asarray(w), jM, jnp.asarray(occ), jitems, jnp.asarray(live),
         None if scales is None else jnp.asarray(scales))
    p = (torch.from_numpy(w), pM, torch.from_numpy(occ), pitems,
         torch.from_numpy(live),
         None if scales is None else torch.from_numpy(scales))
    return j, p


def _assert_lists(s, i, js, ji, near_ties=False):
    """Ids exactly (``near_ties``: but where both scores at the position
    are finite and within the band: the stress case's copies and rows an
    ulp apart); scores exactly where not finite, within 1e-5 (1 + |s|)
    where finite (chip_smoke.py check_topk's band: the stress rows scaled
    2^10 score ~1e3)."""
    s, i, js, ji = s.numpy(), i.numpy(), np.asarray(js), np.asarray(ji)
    fin = np.isfinite(js)
    diff = i != ji
    if near_ties:
        with np.errstate(invalid="ignore"):
            band = np.abs(s - js) <= 1e-5 * (1 + np.abs(js))
        assert (fin & band)[diff].all()
    else:
        np.testing.assert_array_equal(i, ji)
    np.testing.assert_array_equal(np.isfinite(s), fin)
    np.testing.assert_array_equal(s[~fin], js[~fin])
    np.testing.assert_allclose(s[fin], js[fin], rtol=1e-5, atol=1e-5)


def _poisoned(case, alpha):
    """The users whose lists must be all (NaN, INT_MAX)."""
    return {"nan_item": list(range(12)), "nan_dead": [],
            "nan_minv": [2, 5], "big_items": [0], "inf_item": None}[case]


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("case", CASES)
def test_topk_ref_matches_repro_on_non_finite_scores(case, kind):
    """``topk_ref`` (tiles of 16 and of the whole catalog) against
    ``repro``'s ``topk_ref`` on an f32 and a bf16 Minv at alpha 0.3 and
    -0.4: the NaN users' lists (NaN, INT_MAX) in every slot, the others
    unchanged by a NaN on a dead slot."""
    k = 8
    for minv in ("f32", "bf16"):
        j, p = _topk_case(case, kind, minv)
        for alpha in (0.3, -0.4):
            js, ji = jref.topk_ref(*j[:5], alpha, k, row_block=4,
                                   item_block=32, scales=j[5])
            for ib in (16, 4096):
                s, i = ref.topk_ref(*p[:5], alpha, k, item_block=ib,
                                    scales=p[5])
                _assert_lists(s, i, js, ji)
            bad = torch.isnan(s).any(1)
            assert torch.equal(bad, torch.isnan(s).all(1))
            assert bool((i[bad] == INT_MAX).all())
            want = _poisoned(case, alpha)
            if want is not None:
                assert torch.nonzero(bad)[:, 0].tolist() == want
            if case == "nan_dead":     # as if the dead slot were finite
                clean = list(p)
                if kind == "int8":
                    clean[5] = p[5].clone()
                    clean[5][40] = 1.0
                else:
                    clean[3] = p[3].clone()
                    clean[3][40] = 0.0
                s0, i0 = ref.topk_ref(*clean[:5], alpha, k, scales=clean[5])
                assert torch.equal(i0, i) and torch.equal(s0, s)


def _tiles(x, live, T):
    """Tile statistics of a sorted f32 catalog, as core.itemclub keeps
    them (numpy, NaN and inf propagating)."""
    N, d = x.shape
    et = x.reshape(T, N // T, d).astype(np.float64)
    lt = live.reshape(T, N // T)
    cnt = lt.sum(1)
    with np.errstate(invalid="ignore", over="ignore"):
        mu = (et * lt[..., None]).sum(1) / np.maximum(cnt, 1)[:, None]
        r = np.where(lt > 0, np.linalg.norm(et - mu[:, None], axis=-1),
                     0).max(1)
        xn = np.where(lt > 0, np.linalg.norm(et, axis=-1), 0).max(1)
    return [torch.from_numpy(a.astype(t)) for a, t in
            ((mu, np.float32), (r, np.float32), (xn, np.float32),
             (cnt, np.int32))]


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("case", CASES)
def test_topk_ref_pruned_matches_repro_on_the_same_bounds(case, kind):
    """``topk_ref_pruned`` against ``repro``'s on the same tile bounds
    (``tile_bounds`` of the port on the sorted catalog's tiles: NaN where
    a tile or a user's Minv holds a NaN), f32 and bf16 Minv, alpha 0.3
    and -0.4: ids and skip counts exactly; a NaN floor or bound keeps its
    tile."""
    k, T = 8, 12
    perm = np.random.default_rng(9).permutation(96).astype(np.int32)
    for minv in ("f32", "bf16"):
        j, p = _topk_case(case, kind, minv)
        xs = ref.dequantize_rows(p[3], p[5]).numpy()[perm]
        ls = p[4].numpy()[perm]
        tabs = _tiles(xs, ls, T)
        for alpha in (0.3, -0.4):
            tb = ref.tile_bounds(*p[:3], alpha, *tabs)
            jsc = None if j[5] is None else j[5][perm]
            js, ji, jsk, jtot = jref.topk_ref_pruned(
                j[0], j[1], j[2], j[3][perm], j[4][perm], jnp.asarray(perm),
                alpha, k, jnp.asarray(tb.numpy()), scales=jsc)
            psc = None if p[5] is None else p[5][perm]
            s, i, sk, tot = ref.topk_ref_pruned(
                *p[:3], p[3][perm], p[4][perm], torch.from_numpy(perm),
                alpha, k, tb, scales=psc)
            _assert_lists(s, i, js, ji)
            assert (sk, tot) == (int(jsk), int(jtot))


@pytest.mark.parametrize("case", CASES)
def test_retrieval_backend_maps_nan_lists_to_minus_one(case):
    """``RetrievalBackend.shortlist`` against ``repro``'s (its reference
    engine) on an f32 bank and a bf16 Minv: the ids equal, -1 wherever the
    score is not finite, so a NaN user's shortlist is all -1."""
    k = 8
    j, p = _topk_case(case, "f32", "bf16")
    jrb = JConfig.create("reference").retrieval(6, k, row_block=4,
                                                item_block=16)
    rb = BackendConfig.create().retrieval(k)
    for alpha in (0.3, -0.4):
        js, ji = jrb.shortlist(*j[:5], alpha, row0_items=5)
        s, i = rb.shortlist(*p[:5], alpha, row0_items=5)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        bad = torch.isnan(s).any(1)
        assert bool((i[bad] == -1).all())
        assert bool((i[~torch.isfinite(s)] == -1).all())


N_USERS, D, K_CAND, B = 12, 6, 8, 6
N_ITEMS, K_SHORT = 64, 8
HYPER = dict(alpha=0.3, sigma=4, max_rounds=1, gamma=1.5,
             n_candidates=K_CAND, buffer_size=3)
_RNG = np.random.default_rng(3)
THETA = _unit(_RNG.normal(size=(N_USERS, D)))
ITEMS = _unit(_RNG.normal(size=(N_ITEMS, D)))


def _jreward(key, uids, ctx, choice):
    return jenv.step_rewards(key, jnp.asarray(THETA)[uids], ctx, choice)


def _preward(i, uids, ctx, choice):
    u = torch.from_numpy(np.array(jax.random.uniform(
        jax.random.PRNGKey(i), (uids.shape[0],))))
    th = torch.from_numpy(THETA)[uids.clamp(0, N_USERS - 1).long()]
    return env.step_rewards(u, th, ctx, choice)


@pytest.mark.parametrize("nan_at", ["live", "retired"])
def test_session_step_after_a_nan_item_is_published(nan_at):
    """A NaN item added and published (``live``), or added, published and
    then retired (``retired``), before a catalog step of a distclub
    session: the port serves ``repro``'s items (INT_MAX for every user
    while the NaN item is live: ``repro``'s merge of the shortlist), its
    reward, and a state within 1e-5."""
    jc = jserve.make_catalog(jnp.asarray(ITEMS), capacity=N_ITEMS + 8)
    pc = convert.record_from_numpy(jc, serve.Catalog, device="cpu")
    bad = np.full((1, D), 0.1, np.float32)
    bad[0, 2] = NAN
    jc, jslot, _ = jserve.add_items(jc, jnp.asarray(bad))
    pc, pslot, _ = serve.add_items(pc, torch.from_numpy(bad))
    jc, pc = jserve.publish(jc), serve.publish(pc)
    if nan_at == "retired":
        jc, _ = jserve.retire_items(jc, jslot)
        pc, _ = serve.retire_items(pc, pslot)
        jc, pc = jserve.publish(jc), serve.publish(pc)
    js = jserve.OnlineBandit.create(N_USERS, D, JHyper(**HYPER),
                                    policy="distclub", backend="reference")
    ps = serve.OnlineBandit.create(N_USERS, D, BanditHyper(**HYPER),
                                   policy="distclub", device="cpu")
    for step in range(2):
        u = np.arange(step * B, (step + 1) * B, dtype=np.int32)
        js, jit, jm = jserve.step_catalog(js, jax.random.PRNGKey(step),
                                          jnp.asarray(u), jc, _jreward,
                                          k_short=K_SHORT)
        ps, pit, pm = serve.step_catalog(ps, step, torch.from_numpy(u), pc,
                                         _preward, k_short=K_SHORT)
        np.testing.assert_array_equal(pit.numpy(), np.asarray(jit))
        assert float(pm.reward) == float(jm.reward)
        if nan_at == "live":
            assert (pit == INT_MAX).all()
        else:
            assert bool(((pit >= 0) & (pit < N_ITEMS)).all())
    _assert_close(convert.record_to_numpy(ps.state), js.state)


def _assert_close(got, want):
    for f in got._fields:
        g, j = getattr(got, f), getattr(want, f)
        if hasattr(g, "_fields"):
            _assert_close(g, j)
        elif np.issubdtype(np.asarray(j).dtype, np.floating):
            np.testing.assert_allclose(g, np.asarray(j), rtol=0, atol=1e-5,
                                       err_msg=f)
        else:
            np.testing.assert_array_equal(g, np.asarray(j), err_msg=f)


def _jax(t):
    """A CPU tensor as a jax array of the same dtype (bf16 exactly)."""
    if t is None:
        return None
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("which", ["users", "items"])
@pytest.mark.parametrize("kind,minv", [
    ("f32", torch.float32), ("f32", torch.bfloat16),
    ("bf16", torch.float32), ("bf16", torch.bfloat16),
    ("int8", torch.float32), ("int8", torch.bfloat16)])
def test_nonfinite_stress_case_through_the_filter_model(which, kind, minv):
    """``stress_case(nonfinite=...)``, the catalogs chip_smoke.py runs the
    top-K kernels on: ``topk_ref`` equals ``repro``'s ``topk_ref`` (ids
    and the non-finite entries exactly); the filter kernels' plain model
    (``filter_stream_ref``, bf16 and int8 items, f32 items on a bf16
    Minv) passes every NaN pair, so its shortlist is ``topk_ref``'s bit
    for bit, NaN rows included, with no violation; "users" poisons the
    NaN-Minv users (and, through alpha inf 0, the occ-0 ones), "items"
    every user."""
    n, d, N, k = 24, 8, 256, 8
    w, M, occ, items, live, sc = ref.stress_case(5, n, d, N, k, kind,
                                                 minv_dtype=minv,
                                                 nonfinite=which)
    filt = kind != "f32" or minv == torch.bfloat16
    for alpha in (0.3, -0.4):
        s, i = ref.topk_ref(w, M, occ, items, live, alpha, k, scales=sc,
                            item_block=64)
        js, ji = jref.topk_ref(_jax(w), _jax(M), _jax(occ), _jax(items),
                               _jax(live), alpha, k, row_block=8,
                               item_block=64, scales=_jax(sc))
        _assert_lists(s, i, js, ji, near_ties=True)
        bad = torch.isnan(s).any(1)
        assert torch.equal(bad, torch.isnan(s).all(1))
        want = torch.zeros(n, dtype=torch.bool)
        want[3::16] = True
        want[::7] = True              # the 2^70 rows: alpha inf 0
        if which == "items":
            want[:] = True
        assert torch.equal(bad, want)
        if filt:
            fs, fi, _, viol = ref.filter_stream_ref(
                w, M, occ, items, live, alpha, k, scales=sc, chunk=64)
            assert viol == 0 and torch.equal(fi, i)
            assert torch.equal(torch.isnan(fs), torch.isnan(s))
            assert torch.equal(fs[~bad], s[~bad])


@pytest.mark.parametrize("K,d", [(1, 2), (5, 8), (20, 8)])
def test_choose_stress_case_nonfinite_users(K, d):
    """``choose_stress_case(nonfinite=True)``, the users chip_smoke.py
    holds every choose kernel to the plain argmax on: ``choose_ref``
    picks what ``choose_pallas`` picks (interpret mode, the bf16 Minv) on
    every user, at alpha 0.3, -0.4 and 0; the filter's plain model keeps
    all K for every user with a non-finite score."""
    n = 32
    w, M, ctx, occ = iref.choose_stress_case(11 + K, n, K, d,
                                             nonfinite=True)
    for alpha in (0.3, -0.4, 0.0):
        jc, _ = jinteract.choose(_jax(w), _jax(M), _jax(ctx), _jax(occ),
                                 alpha, use_pallas=True, interpret=True,
                                 block_users=32)
        c, x = iref.choose_ref(w, M, ctx, occ, alpha)
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
        s = uref.ucb_scores_ref(w, M, ctx, occ, alpha)
        bad = ~torch.isfinite(s).all(1)
        assert bool(bad[3::16].all()) and bool(bad[5::16].all())
        assert bool(bad[9::16].all()) and bool(bad[13::16].all())
        f = iref.choose_filter_ref(w, M, ctx, occ, alpha)
        nan = torch.isnan(s).any(1)
        assert bool(f["all_survive"][nan].all())
