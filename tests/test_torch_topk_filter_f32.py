"""The tensor-core filter over f32 items with a bf16 ``Minv``
(``csrc/topk_tc.cu``'s ``topk_minv_bf16_tc`` and
``topk_pruned_minv_bf16_tc``: each row split into two bf16 pieces, both
multiplied by Minv's one) in its plain model (``kernels/topk/ref.py``
``filter_ref``): the error bounds against the exact chain of
``csrc/ucb_score.cuh`` with the product summed in every order of
``tc_sum``; the filtered stream against ``topk_ref`` bit for bit and
against ``repro``'s Pallas top-K in interpret mode on a bf16 Minv; the
route, the names and the entries; and the header's derivation."""
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

from test_torch_topk_filter import (  # noqa: E402
    _chain_scores, _same_up_to_near_ties)

ALPHA = 0.3
BF16 = torch.bfloat16


def _case(seed, n, d, N, k):
    return ref.stress_case(seed, n, d, N, k, "f32", minv_dtype=BF16)


@pytest.mark.parametrize("order", ref.ORDERS)
@pytest.mark.parametrize("d", [8, 25, 32])
def test_error_bound_holds_for_f32_items(d, order):
    """(a) |q~ - quad| <= E and |e~ - est| <= E_est for every pair of f32
    items on a bf16 Minv, the product summed in ``order``; also within
    the derived relative errors (Q_EPS_F32, and E_EPS_TC_F32 or
    E_EPS_F32 by where est comes from) of sum |x_i| |M_ij| |x_j| and sum
    |x_j| |w_j|.  Over two seeds of the stress catalog: learned and fresh
    Minv, rows one ulp apart, rows whose lo piece is zero, an ulp, or
    subnormal, f32-subnormal and large rows, zero rows."""
    for seed in (d, d + 100):
        n, N = 11, 300
        w, Minv, occ, items, live, _ = _case(seed, n, d, N, 16)
        score, quad, est = _chain_scores(w, Minv, occ, items, ALPHA)
        plain = ucb_scores_ref(w, Minv, items.expand(n, N, d), occ, ALPHA)
        x = items.double()
        A = torch.einsum("ni,uij,nj->un", x.abs(), Minv.double().abs(),
                         x.abs())
        Aw = (x.abs() @ w.double().abs().T).T
        e_eps = ref.E_EPS_TC_F32 if d <= 30 else ref.E_EPS_F32
        f = ref.filter_ref(w, Minv, occ, items, ALPHA, order=order)
        dq = (f["q"].double() - quad.double()).abs()
        de = (f["e"].double() - est.double()).abs()
        assert bool((dq <= f["E"].double()).all())
        assert bool((de <= f["E_est"].double()).all())
        derived = ref.Q_EPS_F32 * A + ref.ABS * (1 + (x ** 2).sum(1)[None])
        assert bool((dq <= derived).all()), float((dq / derived).max())
        assert bool((de <= e_eps * Aw + ref.ABS).all())
        # the bound never lies under the chain's score or the plain
        # version's; a row that goes to the chain (E = inf) may have ub NaN
        # (inf times a user's zero bonus factor), which passes every floor
        assert not bool((f["ub"] < score).any())
        assert not bool((f["ub"] < plain).any())
        split = torch.isfinite(f["E"])
        assert not bool(torch.isnan(f["ub"][split]).any())
        assert int((~split).sum()) > 0 and bool(split.any())


@pytest.mark.parametrize("alpha", [-0.4, 0.0])
def test_f32_bound_with_a_negative_or_zero_alpha(alpha):
    """alpha < 0 takes the lower end of quad's interval, alpha = 0 only
    est's: the chain's score stays under the bound."""
    w, Minv, occ, items, live, _ = _case(7, 9, 25, 200, 8)
    score, _, _ = _chain_scores(w, Minv, occ, items, alpha)
    for order in ("forward", "truncate"):
        f = ref.filter_ref(w, Minv, occ, items, alpha, order=order)
        assert not bool((f["ub"] < score).any())


def test_item_pieces_are_exact_and_within_2_to_the_minus_16():
    """The split of f32 rows: ahi + alo exact in f32, |x - ahi - alo| <=
    2^-16 |x| on normal features of every magnitude, and ahi, alo bf16
    values."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4000, generator=g) * torch.exp2(
        torch.randint(-100, 100, (4000,), generator=g).float())
    x[:8] = torch.tensor([1.0, -1.0, 1.0 + 2.0 ** -23, 3.0 - 2.0 ** -22,
                          2.0 ** 127, -(2.0 ** -126), 0.0, 255.99998])
    hi, lo = ref.item_pieces(x)
    assert torch.equal(hi, hi.bfloat16().float())
    assert torch.equal(lo, lo.bfloat16().float())
    a = hi + lo
    assert torch.equal(a.double(), hi.double() + lo.double())
    err = (x.double() - a.double()).abs()
    assert bool((err <= 2.0 ** -16 * x.double().abs()).all())
    assert bool((a.double().abs() <= (1 + 2.0 ** -16)
                 * x.double().abs()).all())


def test_f32_items_send_unsplittable_rows_to_the_chain():
    """A NaN feature, a row past kHuge, a feature whose x - ahi is below
    2^-126, an f32-subnormal feature, any nonzero feature below 2^-102
    and a user whose Minv is past kHuge send their pairs to the chain (ub
    NaN or inf); the rest stay finite, a feature of 2^-102 included;
    f32 items with an f32 Minv are refused."""
    w, Minv, occ, items, live, _ = _case(3, 5, 25, 64, 8)
    items = items.clone()
    items[:3] = torch.nn.functional.normalize(torch.randn(
        3, 25, generator=torch.Generator().manual_seed(3)), dim=1)
    items[3, 2] = float("nan")
    items[4] = 2.0 ** 40
    items[5] = 0.0
    items[5, 0] = 2.0 ** -120 + 2.0 ** -135    # x - ahi subnormal
    items[6] = 0.0
    items[6, 1] = 1e-40                         # x subnormal
    items[7] = 0.0
    items[7, 0] = 1.0 + 2.0 ** -23              # lo = 2^-23: relative
    items[8] = 0.0
    items[8, 3] = 2.0 ** -102                   # every piece normal
    items[9] = 0.0
    items[9, 3] = 2.0 ** -102 - 2.0 ** -125     # below 2^-102: the chain
    Minv = Minv.clone()
    Minv[1, 0, 0] = 2.0 ** 70
    f = ref.filter_ref(w, Minv, occ, items, ALPHA)
    ub = f["ub"]
    assert bool(torch.isnan(ub[:, 3]).all())
    for r in (4, 5, 6, 9):
        assert not bool(torch.isfinite(f["E"][:, r]).any()), r
    assert not bool(torch.isfinite(ub[1]).any())
    assert bool(torch.isfinite(ub[0, :3]).all())
    assert bool(torch.isfinite(f["E"][[0, 2, 3, 4]][:, [7, 8]]).all())
    with pytest.raises(ValueError, match="bf16 Minv"):
        ref.filter_ref(w, Minv.float(), occ, items, ALPHA)


@pytest.mark.parametrize("n,d,N,k", [(13, 25, 1100, 64), (9, 32, 700, 1),
                                     (20, 8, 1300, 128), (11, 3, 900, 16)])
def test_f32_filtered_stream_is_the_plain_shortlist(n, d, N, k):
    """(b) Over f32 items on a bf16 Minv, the filter and the exact
    rescoring over a chunked stream give ``topk_ref``'s shortlist bit for
    bit, with no violation and fewer pairs rescored than the stream
    holds; and ``repro``'s Pallas top-K's shortlist in interpret mode but
    for near ties.  n not a multiple of 8, N not one of the chunk, k 1,
    16, 64 and 128, d 3 (est from the product, most features padding)."""
    w, Minv, occ, items, live, _ = _case(n + N + k, n, d, N, k)
    for order in ("forward", "truncate"):
        s, i, rescored, viol = ref.filter_stream_ref(
            w, Minv, occ, items, live, ALPHA, k, order=order)
        want = ref.topk_ref(w, Minv, occ, items, live, ALPHA, k,
                            item_block=ref.FILTER_ROWS)
        assert torch.equal(s, want[0]) and torch.equal(i, want[1])
        assert viol == 0
        assert 0 < rescored < int((live > 0).sum()) * n
    got = ops.topk(w, Minv, occ, items, live, ALPHA, k)
    assert torch.equal(got[0], s) and torch.equal(got[1], i)
    jM = jnp.asarray(Minv.float().numpy()).astype(jnp.bfloat16)
    rs, ri = jtopk.topk(jnp.asarray(w.numpy()), jM, jnp.asarray(occ.numpy()),
                        jnp.asarray(items.numpy()), jnp.asarray(live.numpy()),
                        ALPHA, k, use_pallas=True, block_users=8,
                        block_items=128, interpret=True)
    _same_up_to_near_ties((s, i), (rs, ri))


@pytest.mark.parametrize("k,tile", [(64, 64), (1, 128)])
def test_f32_filtered_stream_is_the_pruned_pallas_shortlist(k, tile):
    """(b) The filtered stream over f32 items on a bf16 Minv is bit for
    bit the port's pruned plain version's shortlist on a cluster-sorted
    layout of the same stress catalog, and ``repro``'s
    ``topk_pruned_pallas`` shortlist (interpret mode, the bf16 Minv) but
    for near ties."""
    n, d, N = 13, 25, 1024
    w, Minv, occ, items, live, _ = _case(11 + k, n, d, N, k)
    s, i, _, viol = ref.filter_stream_ref(w, Minv, occ, items, live, ALPHA,
                                          k)
    assert viol == 0
    key = items @ torch.randn(d, generator=torch.Generator().manual_seed(1))
    perm = torch.argsort(key).to(torch.int32)
    T = N // tile
    it_s, lv_s = items[perm.long()], live[perm.long()]
    et, lt = it_s.view(T, tile, d), lv_s.view(T, tile)
    cnt = lt.sum(1)
    mu = (et * lt[..., None]).sum(1) / cnt.clamp_min(1)[:, None]
    r = torch.where(lt > 0, torch.linalg.norm(et - mu[:, None], dim=-1),
                    0.0).amax(1)
    xn = torch.where(lt > 0, torch.linalg.norm(et, dim=-1), 0.0).amax(1)
    tb = ref.tile_bounds(w, Minv, occ, ALPHA, mu, r, xn, cnt.to(torch.int32))
    ps, pi, _, _ = ops.topk_pruned(w, Minv, occ, it_s, lv_s, perm, ALPHA, k,
                                   tb)
    assert torch.equal(ps, s) and torch.equal(pi, i)
    jM = jnp.asarray(Minv.float().numpy()).astype(jnp.bfloat16)
    want = jtopk.topk_pruned(
        jnp.asarray(w.numpy()), jM, jnp.asarray(occ.numpy()),
        jnp.asarray(it_s.numpy()), jnp.asarray(lv_s.numpy()),
        jnp.asarray(perm.numpy()), ALPHA, k, jnp.asarray(tb.numpy()),
        use_pallas=True, block_users=8, interpret=True)
    _same_up_to_near_ties((s, i), want[:2])


@pytest.mark.parametrize("pruned", [False, True])
def test_route_sends_f32_items_on_a_bf16_minv_to_the_filter(pruned):
    """(c) ``route`` sends f32 items with a bf16 Minv to the filter at d
    <= 32 and to the chain above it or with an f32 Minv (the default);
    the filter's name is the chain kernel's with ``_tc``, its own
    ``KERNELS`` entry, launch count and ``extern "C"`` entry, whose
    arguments are the chain kernel's and ``fstats``; the other kinds'
    routes are as they were."""
    for d in (1, 3, 25, 30, 31, 32):
        assert ops.route(0, d, BF16) == ops.FILTER
        assert ops.route(0, d, torch.float32) == ops.CHAIN
        assert ops.route(0, d) == ops.CHAIN
        for kind in (1, 2):
            for minv in (torch.float32, BF16):
                assert ops.route(kind, d, minv) == ops.route(kind, d)
    for d in (33, 64):
        for kind in (0, 1, 2):
            assert ops.route(kind, d, BF16) == ops.CHAIN
    chain = ops.kernel_name(pruned, 0, BF16)
    name = ops.kernel_name(pruned, 0, BF16, ops.route(0, 25, BF16))
    assert name == chain + "_tc" == (
        "topk_pruned_minv_bf16_tc" if pruned else "topk_minv_bf16_tc")
    assert ops.kernel_name(pruned, 0, BF16, ops.route(0, 33, BF16)) == chain
    src, entry, argtypes = _build.KERNELS[name]
    assert src == "topk_tc.cu" and entry == name + "_launch"
    text = (_build.CSRC / src).read_text()
    assert f'extern "C" int {entry}(' in text
    body = text[text.index(f'extern "C" int {entry}('):]
    body = body[:body.index("}")]
    # the f32 items, the bf16 Minv, item code 0 and Minv's flag 1
    assert "const float* items" in body and "__nv_bfloat16* Minv" in body
    assert re.search(r"Minv, 1, occ, items, live, (ids, )?nullptr, 0,",
                     body)
    assert argtypes == _build.KERNELS[chain][2][:-1] + [_build._P, _build._P]
    assert name in _build.LAUNCHES
    # no filter entry takes f32 items with an f32 Minv
    assert "topk_tc" not in _build.KERNELS
    assert "topk_pruned_tc" not in _build.KERNELS


def test_f32_derived_error_sums_its_terms():
    """(d) Q_EPS_F32, E_EPS_F32 and E_EPS_TC_F32 are the header's sums at
    d = 32, the header states them, and each constant that covers them
    is at least 4 times its derived error."""
    u = 2.0 ** -24

    def g(k):
        return k * u / (1 - k * u)
    p = 1 + 2.0 ** -7 + 2.0 ** -16
    chain = (2 * g(32) + g(32) ** 2) * (1 + u) ** 2
    q = (chain + 2 * 2.0 ** -16 + 2.0 ** -32
         + 68 * 2.0 ** -23 * (1 + 2.0 ** -16) * p
         + g(10) * (1 + 2.0 ** -16) * p * (1 + 1e-5))
    assert q <= ref.Q_EPS_F32 < q * 1.01
    e = 2.0 ** -16 + g(10) * (1 + 2.0 ** -16) + g(32)
    assert e <= ref.E_EPS_F32 < e * 1.01
    etc = (2.0 ** -16 * (1 + 2.0 ** -16) + 2.0 ** -16
           + 68 * 2.0 ** -23 * p * p + g(32) + 3 * u)
    assert etc <= ref.E_EPS_TC_F32 < etc * 1.01
    header = (_build.CSRC / "topk_tc.cu").read_text()
    for v in (ref.Q_EPS_F32, ref.E_EPS_F32, ref.E_EPS_TC_F32):
        assert f"{v:.2e}".replace("e-0", "e-") in header, v
    assert ref.Q_REL >= 4 * ref.Q_EPS_F32
    assert ref.E_REL_TC >= 4 * ref.E_EPS_TC_F32
    assert ref.E_REL_TC >= 4 * ref.E_EPS_F32
    # kERel alone would not cover est on the CUDA cores for f32 items:
    # f32 items take kERelTc there (filter_ref's cW)
    assert ref.E_REL < 4 * ref.E_EPS_F32


def test_stress_case_stresses_the_split():
    """The f32 stress catalog holds rows whose lo piece is zero, an ulp
    of x, and rows that go to the chain, beside the copies of user 0's
    k-th item and its best item one ulp apart; the bf16 and int8 kinds
    are as they were (no f32 row kinds)."""
    w, Minv, occ, items, live, sc = _case(5, 9, 25, 2000, 16)
    assert items.dtype == torch.float32 and sc is None
    assert Minv.dtype == BF16
    hi, lo = ref.item_pieces(items)
    nz = (items != 0).any(1)
    assert int(((lo == 0).all(1) & nz).sum()) > 50
    f = ref.filter_ref(w[:1], Minv[:1], occ[:1], items, ALPHA)
    assert int((~torch.isfinite(f["E"][0])).sum()) > 50
    big = items.norm(dim=1) > 100
    assert int(big.sum()) > 50
    _, counts = torch.unique(items, dim=0, return_counts=True)
    assert int(counts.max()) >= 200
    # rows equal but for feature 0, one ulp apart there
    bits = items.view(torch.int32)
    _, tail, tails = torch.unique(bits[:, 1:], dim=0, return_inverse=True,
                                  return_counts=True)
    near = False
    for grp in torch.nonzero(tails > 1)[:, 0]:
        f0 = torch.unique(bits[tail == grp, 0]).long()
        near |= bool(((f0[1:] - f0[:-1]) == 1).any())
    assert near
    for kind in ("bf16", "int8"):
        _, _, _, q, _, s = ref.stress_case(5, 9, 25, 2000, 16, kind)
        x = ref.dequantize_rows(q, s)
        assert float(x.norm(dim=1).max()) < 8.5
        assert not bool(((x != 0) & (x.abs() < 2.0 ** -126)).any())
