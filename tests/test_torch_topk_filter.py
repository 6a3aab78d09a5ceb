"""The tensor-core filter of the bf16 and int8 top-K kernels
(``csrc/topk_tc.cu``'s filter kernels) in its plain model
(``kernels/topk/ref.py`` ``filter_ref``): the error bound E against the
exact chain of ``csrc/ucb_score.cuh`` with the product summed in several
orders; the filtered stream against ``topk_ref`` bit for bit and against
``repro``'s Pallas top-K in interpret mode, on stress catalogs; and the
route that picks the filter kernels."""
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels.topk import ops as jtopk  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.topk import ops, ref  # noqa: E402
from repro_torch.kernels.ucb.ref import ucb_scores_ref  # noqa: E402

ALPHA = 0.3


def _case(seed, n, d, N, k, kind, minv):
    return ref.stress_case(seed, n, d, N, k, kind,
                           minv_dtype=getattr(torch, minv))


def _a_and_s(items, scales):
    """The rows the filter multiplies (bf16 values or int8 codes) and
    their scales (1 for bf16), in f64."""
    a = items.double()
    if scales is None:
        return a, torch.ones(len(items), dtype=torch.float64)
    return a, scales.double()


def _chain_scores(w, Minv, occ, x, alpha):
    """The chain's scores [n, N] (csrc/ucb_score.cuh, exactly) and its
    quad and est."""
    n = w.shape[0]
    quad, est = ref.chain_ref(Minv, w, x.expand(n, *x.shape).contiguous())
    ex = torch.sqrt(torch.log1p(occ.float()))
    bonus = (alpha * torch.sqrt(torch.clamp_min(quad, 0.0))) * ex[:, None]
    return est + bonus, quad, est


@pytest.mark.parametrize("minv", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("d", [8, 25, 32])
def test_error_bound_holds_in_every_order(d, kind, minv):
    """(a) |q~ - quad| <= E and |e~ - est| <= E_est for every pair, with
    the product summed forward, reversed, pairwise and by the truncating
    model of the tensor cores; also within the derived relative error
    (csrc/topk_tc.cu's header) of the exact sum of |terms|, which E exceeds
    by its safety factor.  Over two seeds, learned (near-singular) and
    fresh Minv, rows of tiny, unit and large norm, zero rows."""
    for seed in (d, d + 100):
        n, N = 11, 300
        w, Minv, occ, items, live, scales = _case(seed, n, d, N, 16, kind,
                                                  minv)
        x = ref.dequantize_rows(items, scales)
        score, quad, est = _chain_scores(w, Minv, occ, x, ALPHA)
        plain = ucb_scores_ref(w, Minv, x.expand(n, N, d), occ, ALPHA)
        a, s = _a_and_s(items, scales)
        M = Minv.double()
        A = torch.einsum("ni,uij,nj->un", a.abs(), M.abs(), a.abs())
        Aw = a.abs() @ w.double().abs().T                 # [N, n]
        e_eps = ref.E_EPS_TC if d <= 30 else ref.E_EPS
        for order in ref.ORDERS:
            f = ref.filter_ref(w, Minv, occ, items, ALPHA, scales=scales,
                               order=order)
            dq = (f["q"].double() - quad.double()).abs()
            de = (f["e"].double() - est.double()).abs()
            assert bool((dq <= f["E"].double()).all()), order
            assert bool((de <= f["E_est"].double()).all()), order
            derived = ref.Q_EPS * s[None] ** 2 * A + ref.ABS * (
                1 + s[None] ** 2 * (a ** 2).sum(1)[None])
            assert bool((dq <= derived).all()), (order, float(
                (dq / derived).max()))
            assert bool((de <= e_eps * s[None] * Aw.T + ref.ABS).all())
            # the bound holds the chain's score and the plain version's
            assert bool((score <= f["ub"]).all()), order
            assert bool((plain <= f["ub"]).all()), order
            assert not bool(torch.isnan(f["ub"]).any())


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_bound_with_a_negative_alpha(kind):
    """alpha < 0 takes the lower end of quad's interval: the chain's
    score stays under the bound."""
    w, Minv, occ, items, live, scales = _case(7, 9, 25, 200, 8, kind,
                                              "float32")
    x = ref.dequantize_rows(items, scales)
    score, _, _ = _chain_scores(w, Minv, occ, x, -0.4)
    for order in ("forward", "truncate"):
        f = ref.filter_ref(w, Minv, occ, items, -0.4, scales=scales,
                           order=order)
        assert bool((score <= f["ub"]).all())


def test_non_finite_and_huge_inputs_pass():
    """A NaN feature, a row past kHuge and a user whose Minv is past it
    send their pairs to the chain (ub NaN or inf)."""
    w, Minv, occ, items, live, scales = _case(3, 5, 25, 64, 8, "bf16",
                                              "float32")
    items = items.clone()
    items[3, 2] = float("nan")
    items[4] = (torch.ones(25) * 2.0 ** 40).bfloat16()
    Minv = Minv.clone()
    Minv[1, 0, 0] = 2.0 ** 70
    f = ref.filter_ref(w, Minv, occ, items, ALPHA)
    ub = f["ub"]
    assert bool(torch.isnan(ub[:, 3]).all())
    assert not bool(torch.isfinite(ub[:, 4]).any())
    assert not bool(torch.isfinite(ub[1]).any())
    assert bool(torch.isfinite(ub[0, :3]).all())


def _same_up_to_near_ties(got, want, tol=1e-5):
    """Shortlists equal but where scores tie within ``tol`` (relative):
    an id in one list and not the other scores within tol of the k-th
    score; shared ids score within tol."""
    gs, gi = (np.asarray(t) for t in got)
    ws, wi = (np.asarray(t) for t in want)
    ties = 0
    for u in range(gs.shape[0]):
        fin_g, fin_w = np.isfinite(gs[u]), np.isfinite(ws[u])
        assert fin_g.sum() == fin_w.sum(), u
        g = dict(zip(gi[u][fin_g].tolist(), gs[u][fin_g].tolist()))
        h = dict(zip(wi[u][fin_w].tolist(), ws[u][fin_w].tolist()))
        if not g:
            continue
        scale = max(1.0, max(abs(v) for v in g.values()))
        floor = min(g.values())
        for i in set(g) & set(h):
            assert abs(g[i] - h[i]) <= tol * scale, (u, i)
        for i in set(g) ^ set(h):
            v = g.get(i, h.get(i))
            assert abs(v - floor) <= tol * scale, (u, i, v, floor)
            ties += 1
    return ties


def _repro_items(items, scales):
    if scales is None:
        return jnp.asarray(items.float().numpy()).astype(jnp.bfloat16), None
    return jnp.asarray(items.numpy()), jnp.asarray(scales.numpy())


@pytest.mark.parametrize("minv", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("n,d,N,k", [(13, 25, 1100, 64), (9, 32, 700, 1),
                                     (20, 8, 1300, 128)])
def test_filtered_stream_is_the_plain_shortlist(n, d, N, k, kind, minv):
    """(b) The filter and the exact rescoring over a chunked stream give
    ``topk_ref``'s shortlist bit for bit, with no violation and fewer
    pairs scored than the stream holds; and ``repro``'s Pallas top-K's
    shortlist in interpret mode but for near ties.  n is not a multiple
    of 8, N not one of the filter's chunk, k 1, 64 and 128."""
    w, Minv, occ, items, live, scales = _case(n + N + k, n, d, N, k, kind,
                                              minv)
    for order in ("forward", "truncate"):
        s, i, rescored, viol = ref.filter_stream_ref(
            w, Minv, occ, items, live, ALPHA, k, scales=scales, order=order)
        want = ref.topk_ref(w, Minv, occ, items, live, ALPHA, k,
                            scales=scales, item_block=ref.FILTER_ROWS)
        assert torch.equal(s, want[0]) and torch.equal(i, want[1])
        assert viol == 0
        assert 0 < rescored < int((live > 0).sum()) * n
    # the port's top-K wrapper (the plain version on the CPU) agrees
    got = ops.topk(w, Minv, occ, items, live, ALPHA, k, scales=scales)
    assert torch.equal(got[0], s) and torch.equal(got[1], i)
    jx, jsc = _repro_items(items, scales)
    jM = jnp.asarray(Minv.float().numpy()).astype(
        jnp.bfloat16 if minv == "bfloat16" else jnp.float32)
    rs, ri = jtopk.topk(jnp.asarray(w.numpy()), jM, jnp.asarray(occ.numpy()),
                        jx, jnp.asarray(live.numpy()), ALPHA, k,
                        use_pallas=True, block_users=8, block_items=128,
                        interpret=True, scales=jsc)
    _same_up_to_near_ties((s, i), (rs, ri))


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_filtered_stream_is_the_pruned_pallas_shortlist(kind):
    """(b) The filtered stream's shortlist is ``repro``'s
    ``topk_pruned_pallas`` shortlist (interpret mode, a cluster-sorted
    layout of the same stress catalog) but for near ties, and bit for
    bit the port's pruned plain version's."""
    n, d, N, k, tile = 13, 25, 1024, 64, 64
    w, Minv, occ, items, live, scales = _case(11, n, d, N, k, kind,
                                              "float32")
    s, i, _, viol = ref.filter_stream_ref(w, Minv, occ, items, live, ALPHA,
                                          k, scales=scales)
    assert viol == 0
    deq = ref.dequantize_rows(items, scales)
    key = deq @ torch.randn(d, generator=torch.Generator().manual_seed(1))
    perm = torch.argsort(key).to(torch.int32)
    T = N // tile
    it_s, lv_s = items[perm.long()], live[perm.long()]
    sc_s = None if scales is None else scales[perm.long()]
    et = deq[perm.long()].view(T, tile, d)
    lt = lv_s.view(T, tile)
    cnt = lt.sum(1)
    mu = (et * lt[..., None]).sum(1) / cnt.clamp_min(1)[:, None]
    r = torch.where(lt > 0, torch.linalg.norm(et - mu[:, None], dim=-1),
                    0.0).amax(1)
    xn = torch.where(lt > 0, torch.linalg.norm(et, dim=-1), 0.0).amax(1)
    tb = ref.tile_bounds(w, Minv, occ, ALPHA, mu, r, xn, cnt.to(torch.int32))
    ps, pi, skipped, _ = ops.topk_pruned(w, Minv, occ, it_s, lv_s, perm,
                                         ALPHA, k, tb, scales=sc_s)
    assert torch.equal(ps, s) and torch.equal(pi, i)
    jx, jsc = _repro_items(it_s, sc_s)
    want = jtopk.topk_pruned(
        jnp.asarray(w.numpy()), jnp.asarray(Minv.numpy()),
        jnp.asarray(occ.numpy()), jx, jnp.asarray(lv_s.numpy()),
        jnp.asarray(perm.numpy()), ALPHA, k, jnp.asarray(tb.numpy()),
        use_pallas=True, block_users=8, interpret=True, scales=jsc)
    _same_up_to_near_ties((s, i), want[:2])


def test_route_picks_the_filter_kernels_up_to_d_32():
    """(c) ``ops.route`` sends bf16 and int8 items at d <= 32 to the
    filter kernels and everything else to the chain kernels; the filter
    names end in ``_tc``, each its own launch count and ``extern "C"``
    entry, whose arguments are the chain kernel's and ``fstats``."""
    for kind in (1, 2):
        for d in (1, 25, 30, 31, 32):
            assert ops.route(kind, d) == ops.FILTER
        for d in (33, 64):
            assert ops.route(kind, d) == ops.CHAIN
    for d in (8, 25, 32, 64):
        assert ops.route(0, d) == ops.CHAIN
    for pruned in (False, True):
        for kind in (1, 2):
            for minv in (torch.float32, torch.bfloat16):
                chain = ops.kernel_name(pruned, kind, minv)
                name = ops.kernel_name(pruned, kind, minv, ops.FILTER)
                assert name == chain + "_tc"
                assert ops.kernel_name(pruned, kind, minv,
                                       ops.route(kind, 25)) == name
                assert ops.kernel_name(pruned, kind, minv,
                                       ops.route(kind, 33)) == chain
                src, entry, argtypes = _build.KERNELS[name]
                assert src == "topk_tc.cu" and entry == name + "_launch"
                assert f'extern "C" int {entry}(' in (
                    _build.CSRC / src).read_text()
                assert argtypes == _build.KERNELS[chain][2][:-1] + [
                    _build._P, _build._P]
                assert _build.LAUNCHES[name] == 0
    with pytest.raises(ValueError, match="route"):
        ops.kernel_name(False, 1, torch.float32, "wgmma")


def test_a_named_route_must_take_the_shape():
    """The one route a caller names is the chain (``chain=True``, the
    yardstick the filter kernels are timed against); the filter is never
    named, so it cannot be asked for at a shape it does not take.  On the
    CPU every wrapper is the plain version whatever the caller names."""
    for fn in (ops.topk, ops.topk_pruned, ops.pruned_launch):
        assert "chain" in fn.__kwdefaults__ and "route" not in (
            fn.__kwdefaults__), fn
    w, M, occ, items, live, sc = _case(5, 9, 25, 300, 8, "int8", "float32")
    got = ops.topk(w, M, occ, items, live, ALPHA, 8, scales=sc)
    yard = ops.topk(w, M, occ, items, live, ALPHA, 8, scales=sc, chain=True)
    want = ref.topk_ref(w, M, occ, items, live, ALPHA, 8, scales=sc)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for a, b in zip(yard, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="route"):
        ops.kernel_name(True, 2, torch.float32, "tensor")


def test_filter_stats_sum_the_launches_in_the_block():
    """``FilterStats`` sums the (rescored, violations) pairs of the
    launches recorded inside its block, nested blocks each their own, and
    nothing is kept outside one."""
    def fstats(r, v):
        f = torch.zeros(2, 3, ops.USERS_PER_BLOCK, 2, dtype=torch.int32)
        f[1, 2, 5] = torch.tensor([r, v], dtype=torch.int32)
        return f

    ops._record(fstats(7, 1))
    assert not ops._SINKS
    with ops.FilterStats() as outer:
        ops._record(fstats(100, 0))
        with ops.FilterStats() as inner:
            ops._record(fstats(2**30, 2))
            ops._record(fstats(2**30, 0))
        ops._record(fstats(3, 0))
    assert not ops._SINKS
    assert (inner.rescored, inner.violations) == (2**31, 2)
    assert (outer.rescored, outer.violations) == (2**31 + 103, 2)
    with ops.FilterStats() as empty:
        pass
    assert (empty.rescored, empty.violations) == (0, 0)


def _cu(name, kind=int, source="topk_tc.cu"):
    text = (_build.CSRC / source).read_text()
    if kind is int:
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             text).group(1))
    m = re.search(rf"constexpr float {name} = 0x1p(-?\d+)f;", text)
    return 2.0 ** int(m.group(1))


def test_the_models_constants_are_the_kernels():
    """``filter_ref``'s constants and the wrapper's chunk are
    csrc/topk_tc.cu's, whose shared constants are topk.cu's; each relative
    constant is at least 4 times its derived error."""
    for name in ("kUsers", "kThreads", "kMaxK", "kSmallD", "kMaxTiles"):
        assert _cu(name) == _cu(name, source="topk.cu"), name
    assert ref.Q_REL == _cu("kQRel", float)
    assert ref.E_REL == _cu("kERel", float)
    assert ref.E_REL_TC == _cu("kERelTc", float)
    assert ref.ABS == _cu("kAbs", float)
    assert ref.HUGE == _cu("kHuge", float)
    assert ref.FILTER_ROWS == ops.TC_ROWS == _cu("kTcRows")
    assert ref.Q_REL >= 4 * ref.Q_EPS
    assert ref.E_REL >= 4 * ref.E_EPS and ref.E_REL_TC >= 4 * ref.E_EPS_TC
    assert ops.tiles_per_chunk(512, 25, ops.TC_ROWS) == 1
    assert ops.tiles_per_chunk(100, 25, ops.TC_ROWS) == 5
    assert ops.pruned_chunks(512, 512, 25, ops.TC_ROWS) == 512


def test_derived_error_sums_its_terms():
    """Q_EPS, E_EPS and E_EPS_TC are the header's sums at d = 32."""
    u = 2.0 ** -24

    def g(k):
        return k * u / (1 - k * u)
    chain = (2 * g(32) + g(32) ** 2) * (1 + u) ** 2
    q = (chain + 2 * u + u * u + 2.0 ** -16 + 68 * 2.0 ** -23
         * (1 + 2.0 ** -7) + g(10) * (1 + 1e-5) * (1 + 2.0 ** -7) + g(2))
    assert q <= ref.Q_EPS < q * 1.01
    e = g(10) + g(32) + 2 * u
    assert e <= ref.E_EPS < e * 1.01
    etc = 2.0 ** -16 + 68 * 2.0 ** -23 * (1 + 2.0 ** -7) + g(32) + 3 * u
    assert etc <= ref.E_EPS_TC < etc * 1.01


def test_fmaf_ref_rounds_once():
    """fmaf_ref is the correctly rounded a b + c (against exact rational
    arithmetic), including the cases where rounding the f64 sum twice
    would differ."""
    from fractions import Fraction
    g = torch.Generator().manual_seed(0)
    a = torch.randn(400, generator=g)
    b = torch.randn(400, generator=g)
    c = torch.randn(400, generator=g) * 1e-4
    # a b + c exactly half way between two floats, plus a little
    a[:4] = 1.0 + 2.0 ** -23
    b[:4] = 1.0 + 2.0 ** -23
    c[:4] = torch.tensor([2.0 ** -60, -2.0 ** -60, 0.0, 2.0 ** -47])
    got = ref.fmaf_ref(a, b, c)
    for i in range(400):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(
            float(c[i]))
        f = np.float32(float(exact))
        cands = [np.nextafter(f, np.float32(-np.inf)), f,
                 np.nextafter(f, np.float32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.float32(v).view(np.int32))
                                         & 1))
        assert np.float32(got[i]) == best, i
