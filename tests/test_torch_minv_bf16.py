"""The kernels that read ``Minv``, on a bf16 ``Minv`` (``Precision``'s
state dtype), against the reference's Pallas kernels in interpret mode on
the CPU, from numpy inputs:

  * ``rank1_update`` (the M-ful update): ``Minv`` within one bf16 ulp or
    1e-5, ``M`` and ``b`` within 1e-5, in place, through CLUB's one-row
    views; its plain version is the f32 update on the widened ``Minv``
    rounded back to nearest even;
  * ``choose`` and ``ucb_scores``: the same picks on inputs kept away
    from ties, scores within f32 rtol 1e-6, and both equal to the port's
    own f32 results on ``Minv.float()`` (widening is exact);
  * ``topk`` / ``topk_pruned`` over f32, bf16 and int8 items: the same
    ids, scores within rtol 1e-6;
  * ``InteractBackend`` against ``repro``'s pallas-kind engine under the
    bf16 preset over a few lockstep rounds;
  * the pure dispatch: each wrapper's kernel by ``Minv``'s dtype,
    ``tile_smem`` and ``geometry`` with a bf16 region, and ``TypeError``
    for an f16 ``Minv``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import serve as jserve  # noqa: E402
from repro.core import backend as jbackend  # noqa: E402
from repro.core.types import LinUCBState as JLin  # noqa: E402
from repro.kernels.interact import ops as jinteract  # noqa: E402
from repro.kernels.rank1 import ops as jrank1  # noqa: E402
from repro.kernels.topk import ops as jtopk  # noqa: E402
from repro.kernels.ucb import ops as jucb  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core.backend import BackendConfig  # noqa: E402
from repro_torch.core.types import LinUCBState  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.interact import ops as interact  # noqa: E402
from repro_torch.kernels.rank1 import ops as rank1  # noqa: E402
from repro_torch.kernels.rank1 import ref as rank1_ref  # noqa: E402
from repro_torch.kernels.topk import ops as topk  # noqa: E402
from repro_torch.kernels.topk import ref as topk_ref  # noqa: E402
from repro_torch.kernels.ucb import ops as ucb  # noqa: E402

ALPHA = 0.3
ITEM_KINDS = ("f32", "bf16", "int8")


def _unit(a):
    return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)


def _minv_bf16(rng, n, d):
    """An SPD inverse stored in bf16: (reference array, port tensor),
    the same bits."""
    A = 0.1 * rng.normal(size=(n, d, d))
    Minv = np.linalg.inv(np.eye(d) + A @ A.transpose(0, 2, 1)).astype(
        np.float32)
    jM = jnp.asarray(Minv).astype(jnp.bfloat16)
    return jM, convert._tensor(np.asarray(jM), "cpu")


def _ordered(t: torch.Tensor) -> torch.Tensor:
    """bf16 values as ordered ints: one apart = one ulp apart."""
    bits = t.contiguous().view(torch.int16).to(torch.int32)
    return torch.where(bits >= 0, bits, -32768 - bits)


def assert_minv_close(got: torch.Tensor, want) -> None:
    """Every bf16 element within one ulp of ``want`` or within 1e-5 of it
    (the two sum Minv x in other orders, so their f32 values part by a
    few f32 ulps before the rounding; where the downdate cancels, a value
    far below 1 holds that as several of its own bf16 ulps)."""
    want = convert._tensor(np.asarray(want), "cpu")
    assert got.dtype == want.dtype == torch.bfloat16
    ulps = (_ordered(got) - _ordered(want)).abs()
    gap = (got.float() - want.float()).abs()
    bad = (ulps > 1) & (gap > 1e-5)
    assert not bool(bad.any()), f"{int(bad.sum())} elements apart"


# ---------------------------------------------------------------------------
# the M-ful rank-1 update
# ---------------------------------------------------------------------------


def _mful_inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    jMinv, Minv = _minv_bf16(rng, n, d)
    M = np.linalg.inv(np.asarray(jMinv.astype(jnp.float32))).astype(
        np.float32)
    b = rng.normal(size=(n, d)).astype(np.float32)
    x = _unit(rng.normal(size=(n, d)))
    r = rng.random(n).astype(np.float32)
    mask = rng.random(n) < 0.7
    mask[0], mask[-1] = True, n == 1
    return jMinv, Minv, M, b, x, r, mask


@pytest.mark.parametrize("n,d", [(37, 25), (64, 32), (5, 3), (1, 25),
                                 (9, 64)])
def test_rank1_update_on_a_bf16_minv_matches_pallas_interpret(n, d):
    """The plain version takes a bf16 Minv (it ran einsum on the bf16
    Minv against an f32 x before, which raised) and returns it in bf16,
    updated in place, as ``repro``'s kernel returns it."""
    jMinv, Minv, M, b, x, r, mask = _mful_inputs(n, d, seed=7 * n + d)
    want = jrank1.rank1_update(
        jnp.asarray(M), jMinv, *(jnp.asarray(a) for a in (b, x, r, mask)),
        use_pallas=True, interpret=True)
    assert want[1].dtype == jnp.bfloat16
    inputs = [torch.from_numpy(M.copy()), Minv.clone(),
              torch.from_numpy(b.copy())]
    got = rank1.rank1_update(*inputs, torch.from_numpy(x),
                             torch.from_numpy(r), torch.from_numpy(mask))
    assert all(g is i for g, i in zip(got, inputs))
    assert got[0].dtype == torch.float32 and got[2].dtype == torch.float32
    assert_minv_close(got[1], want[1])
    for g, w_ in ((got[0], want[0]), (got[2], want[2])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w_), rtol=0,
                                   atol=1e-5)
    # masked-out users are identity updates, bit for bit
    off = torch.from_numpy(~mask)
    for g, a in zip(got, (torch.from_numpy(M), Minv, torch.from_numpy(b))):
        assert torch.equal(g[off], a[off])


def test_rank1_update_bf16_plain_is_the_f32_update_rounded():
    """Widen once, the f32 update in its order, round to nearest even: the
    bf16 plain version's Minv is the f32 plain version's on the widened
    Minv, rounded; M and b are the f32 version's bit for bit."""
    _, Minv, M, b, x, r, mask = _mful_inputs(23, 19, seed=3)
    rest = [torch.from_numpy(a) for a in (x, r, mask)]
    got = rank1_ref.rank1_update_ref(torch.from_numpy(M.copy()),
                                     Minv.clone(),
                                     torch.from_numpy(b.copy()), *rest)
    f32 = rank1_ref.rank1_update_ref(torch.from_numpy(M.copy()),
                                     Minv.float(),
                                     torch.from_numpy(b.copy()), *rest)
    assert torch.equal(got[1], f32[1].bfloat16())
    assert torch.equal(got[0], f32[0]) and torch.equal(got[2], f32[2])


def test_rank1_update_bf16_writes_through_a_row_view():
    """CLUB's call on a bf16 state: user ``u``'s row views updated in
    place, every other row as it was."""
    n, d, u = 9, 25, 4
    jMinv, Minv, M, b, x, r, _ = _mful_inputs(n, d, seed=11)
    state = [torch.from_numpy(M.copy()), Minv.clone(),
             torch.from_numpy(b.copy())]
    live = torch.ones(1, dtype=torch.bool)
    rank1.rank1_update(*(t[u:u + 1] for t in state),
                       torch.from_numpy(x[u:u + 1]),
                       torch.from_numpy(r[u:u + 1]), live)
    want = jrank1.rank1_update(
        jnp.asarray(M[u:u + 1]), jMinv[u:u + 1],
        *(jnp.asarray(a[u:u + 1]) for a in (b, x, r)), jnp.ones(1, bool),
        use_pallas=True, interpret=True)
    assert_minv_close(state[1][u:u + 1], want[1])
    np.testing.assert_allclose(state[0][u:u + 1].numpy(),
                               np.asarray(want[0]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(state[2][u:u + 1].numpy(),
                               np.asarray(want[2]), rtol=0, atol=1e-5)
    keep = torch.ones(n, dtype=torch.bool)
    keep[u] = False
    for t, a in zip(state, (torch.from_numpy(M), Minv, torch.from_numpy(b))):
        assert torch.equal(t[keep], a[keep])


# ---------------------------------------------------------------------------
# choose and ucb
# ---------------------------------------------------------------------------


def _score_inputs(n, K, d, seed):
    rng = np.random.default_rng(seed)
    w = (0.3 * rng.normal(size=(n, d))).astype(np.float32)
    jMinv, Minv = _minv_bf16(rng, n, d)
    ctx = _unit(rng.normal(size=(n, K, d)))
    occ = rng.integers(0, 1000, n).astype(np.int32)
    return w, jMinv, Minv, ctx, occ


def _clear_of_ties(scores: torch.Tensor, gap: float = 1e-4) -> torch.Tensor:
    """The rows whose best score leads the second by more than ``gap``."""
    top2 = torch.topk(scores, 2, dim=-1).values
    return top2[:, 0] - top2[:, 1] > gap


@pytest.mark.parametrize("n,K,d", [(37, 20, 25), (64, 7, 19), (9, 64, 32),
                                   (5, 33, 3), (1, 20, 25)])
def test_choose_and_ucb_on_a_bf16_minv_match_pallas_interpret(n, K, d):
    w, jMinv, Minv, ctx, occ = _score_inputs(n, K, d, seed=n * 100 + K)
    jw, jctx, jocc = (jnp.asarray(a) for a in (w, ctx, occ))
    jc, jx = jinteract.choose(jw, jMinv, jctx, jocc, ALPHA, use_pallas=True,
                              interpret=True)
    js = jucb.ucb_scores(jw, jMinv, jctx, jocc, ALPHA, use_pallas=True,
                         interpret=True)
    assert js.dtype == jnp.float32
    t = [torch.from_numpy(w), Minv, torch.from_numpy(ctx),
         torch.from_numpy(occ)]
    before = dict(_build.LAUNCHES)
    c, x = interact.choose(*t, ALPHA)
    s = ucb.ucb_scores(*t, ALPHA)
    assert _build.LAUNCHES == before            # CPU: the plain versions
    assert s.dtype == torch.float32 and s.shape == (n, K)
    # d-term f32 sums in another order: rtol 1e-6, and a few ulps of the
    # O(1) terms (atol 1e-6, as the f32 scores' test) where they cancel
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6,
                               atol=1e-6)
    clear = _clear_of_ties(s) if K > 1 else torch.ones(n, dtype=torch.bool)
    assert int(clear.sum()) >= 0.8 * n
    np.testing.assert_array_equal(c.numpy()[clear.numpy()],
                                  np.asarray(jc)[clear.numpy()])
    np.testing.assert_array_equal(x.numpy(), ctx[np.arange(n), c.numpy()])
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=2e-5)
    assert torch.equal(torch.argmax(s, dim=-1).to(torch.int32), c)
    # a bf16 Minv scores as its f32 widening, bit for bit
    t32 = [t[0], Minv.float(), t[2], t[3]]
    assert torch.equal(s, ucb.ucb_scores(*t32, ALPHA))
    c32, x32 = interact.choose(*t32, ALPHA)
    assert torch.equal(c, c32) and torch.equal(x, x32)


# ---------------------------------------------------------------------------
# top-K over each item kind
# ---------------------------------------------------------------------------


def _bank(kind, x):
    """``x`` stored as the reference's bank of ``kind``: (reference items,
    reference scales or None, port items, port scales or None)."""
    if kind == "f32":
        return jnp.asarray(x), None, torch.from_numpy(x), None
    jc = jserve.make_catalog(jnp.asarray(x), precision=jbackend.Precision(
        *jbackend.resolve_precision(kind)._replace(scale_block=32)))
    pc = convert.catalog_from_numpy(jax.tree.map(np.asarray, jc),
                                    device="cpu")
    if kind == "int8":
        return jc.serving.emb, jc.serving.scale, pc.serving.emb, \
            pc.serving.scale
    return jc.serving.emb, None, pc.serving.emb, None


def _assert_shortlists(got, want):
    s, i = got
    js, ji = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(i.numpy(), ji)
    fin = np.isfinite(js)
    np.testing.assert_array_equal(np.isfinite(s.numpy()), fin)
    np.testing.assert_allclose(s.numpy()[fin], js[fin], rtol=1e-6, atol=0)


@pytest.mark.parametrize("kind", ITEM_KINDS)
@pytest.mark.parametrize("n,d,N,k", [(37, 25, 700, 16), (8, 16, 512, 64)])
def test_topk_on_a_bf16_minv_matches_pallas_interpret(kind, n, d, N, k):
    rng = np.random.default_rng(n + N + len(kind))
    w = rng.normal(size=(n, d)).astype(np.float32)
    jMinv, Minv = _minv_bf16(rng, n, d)
    occ = rng.integers(0, 50, n).astype(np.int32)
    live = (rng.random(N) > 0.2).astype(np.float32)
    jx, jsc, px, psc = _bank(kind, _unit(rng.normal(size=(N, d))))
    want = jtopk.topk(jnp.asarray(w), jMinv, jnp.asarray(occ), jx,
                      jnp.asarray(live), ALPHA, k, use_pallas=True,
                      block_users=8, block_items=128, interpret=True,
                      scales=jsc)
    stats = (torch.from_numpy(w), Minv, torch.from_numpy(occ))
    got = topk.topk(*stats, px, torch.from_numpy(live), ALPHA, k,
                    scales=psc)
    _assert_shortlists(got, want)
    # the shortlist of the widened Minv, bit for bit
    again = topk.topk(stats[0], Minv.float(), stats[2], px,
                      torch.from_numpy(live), ALPHA, k, scales=psc)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.parametrize("kind", ITEM_KINDS)
def test_topk_pruned_on_a_bf16_minv_matches_pallas_interpret(kind):
    n, d, N, tile, k = 16, 16, 1024, 64, 16
    rng = np.random.default_rng(5)
    _, Minv = _minv_bf16(rng, n, d)
    jMinv = jnp.asarray(Minv.float().numpy()).astype(jnp.bfloat16)
    occ = rng.integers(0, 50, n).astype(np.int32)
    c = _unit(rng.normal(size=(8, d)))
    w = (2.0 * c[rng.integers(0, 8, n)]).astype(np.float32)
    x = _unit(c[np.arange(N) // (N // 8)] + 0.05 * rng.normal(size=(N, d)))
    live = (rng.random(N) > 0.1).astype(np.float32)
    ids = rng.permutation(N).astype(np.int32)
    jx, jsc, px, psc = _bank(kind, x)
    deq = topk_ref.dequantize_rows(px, psc)
    T = N // tile
    et, lt = deq.view(T, tile, d), torch.from_numpy(live).view(T, tile)
    cnt = lt.sum(1)
    mu = (et * lt[..., None]).sum(1) / cnt.clamp_min(1)[:, None]
    r = torch.where(lt > 0, torch.linalg.norm(et - mu[:, None], dim=-1),
                    0.0).amax(1)
    xn = torch.where(lt > 0, torch.linalg.norm(et, dim=-1), 0.0).amax(1)
    stats = [torch.from_numpy(w), Minv, torch.from_numpy(occ)]
    tb = topk_ref.tile_bounds(*stats, ALPHA, mu, r, xn, cnt.to(torch.int32))
    want = jtopk.topk_pruned(jnp.asarray(w), jMinv, jnp.asarray(occ), jx,
                             jnp.asarray(live), jnp.asarray(ids), ALPHA, k,
                             jnp.asarray(tb.numpy()), use_pallas=True,
                             block_users=8, interpret=True, scales=jsc)
    s, i, skipped, total = topk.topk_pruned(
        *stats, px, torch.from_numpy(live), torch.from_numpy(ids), ALPHA, k,
        tb, scales=psc)
    _assert_shortlists((s, i), want[:2])
    assert skipped > 0 and total == T * 2
    # bit-equal to the unpruned shortlist over the same rows by slot id,
    # and to the pruned one on the widened Minv
    inv = torch.argsort(torch.from_numpy(ids).long())
    su, iu = topk.topk(*stats, px[inv], torch.from_numpy(live)[inv], ALPHA, k,
                       scales=None if psc is None else psc[inv])
    assert torch.equal(s, su) and torch.equal(i, iu)
    s32, i32, _, _ = topk.topk_pruned(
        stats[0], Minv.float(), stats[2], px, torch.from_numpy(live),
        torch.from_numpy(ids), ALPHA, k, tb, scales=psc)
    assert torch.equal(s, s32) and torch.equal(i, i32)


# ---------------------------------------------------------------------------
# the engines, in lockstep
# ---------------------------------------------------------------------------


def test_engines_on_a_bf16_state_match_the_reference_in_lockstep():
    """``repro``'s pallas-kind engine under the bf16 preset against the
    port's: each round both choose from their own state (the same picks
    where the round's scores are clear of ties), then update it with the
    same rewards and mask; their states stay within the bf16 update's
    tolerance of each other, and the port's is updated in place."""
    n, d, K, rounds = 40, 25, 20, 4
    rng = np.random.default_rng(31)
    jMinv, Minv = _minv_bf16(rng, n, d)
    M = np.linalg.inv(np.asarray(jMinv.astype(jnp.float32))).astype(
        np.float32)
    b = (0.1 * rng.normal(size=(n, d))).astype(np.float32)
    occ = rng.integers(0, 20, n).astype(np.int32)
    jbe = jbackend.BackendConfig.create("pallas", "bf16").interact(
        n, d, K, interpret=True)
    be = BackendConfig.create("bf16").interact()
    jlin = JLin(jnp.asarray(M), jMinv, jnp.asarray(b), jnp.asarray(occ))
    lin = LinUCBState(torch.from_numpy(M.copy()), Minv.clone(),
                      torch.from_numpy(b.copy()), torch.from_numpy(occ))
    given = tuple(lin)
    for _ in range(rounds):
        ctx = _unit(rng.normal(size=(n, K, d)))
        r = (rng.random(n) < 0.5).astype(np.float32)
        mask = rng.random(n) < 0.9
        jw = jnp.einsum("nij,nj->ni", jlin.Minv.astype(jnp.float32), jlin.b)
        w = torch.einsum("nij,nj->ni", lin.Minv.float(), lin.b)
        jx, jc = jbe.choose(jw, jlin.Minv, jnp.asarray(ctx), jlin.occ, ALPHA)
        x, c = be.choose(w, lin.Minv, torch.from_numpy(ctx), lin.occ, ALPHA)
        clear = _clear_of_ties(ucb.ucb_scores(
            w, lin.Minv, torch.from_numpy(ctx), lin.occ, ALPHA)).numpy()
        assert clear.sum() >= 0.8 * n
        np.testing.assert_array_equal(c.numpy()[clear],
                                      np.asarray(jc)[clear])
        # both update on the reference's pick, so that the states meet
        # the same data where a near tie parted the picks
        jx_t = torch.from_numpy(np.array(jx))
        jlin = jbe.update_lin(jlin, jx, jnp.asarray(r), jnp.asarray(mask))
        lin = be.update_lin(lin, jx_t, torch.from_numpy(r),
                            torch.from_numpy(mask))
        assert all(a is g for a, g in zip(lin, given))  # all four in place
        assert lin.Minv.dtype == torch.bfloat16
        assert_minv_close(lin.Minv, jlin.Minv)
        np.testing.assert_allclose(lin.M.numpy(), np.asarray(jlin.M),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(lin.b.numpy(), np.asarray(jlin.b),
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(lin.occ.numpy(), np.asarray(jlin.occ))


# ---------------------------------------------------------------------------
# dispatch by Minv's dtype
# ---------------------------------------------------------------------------


def test_each_wrapper_names_its_kernel_by_minv_dtype():
    """f32 and bf16 Minv each have a kernel of their own, and launch count,
    with the arguments of its f32 twin; an f16 Minv has none and raises
    ``TypeError``, the error a wrapper raises for it on a CUDA tensor."""
    f32, bf16, f16 = (torch.zeros(1, dtype=t) for t in (
        torch.float32, torch.bfloat16, torch.float16))
    for kernels, op in ((interact.KERNELS, "choose"), (ucb.KERNELS, "ucb"),
                        (rank1.KERNELS, "rank1_update"),
                        (rank1.INV_KERNELS, "rank1_update_inv")):
        assert _build.minv_kernel(kernels, f32, op) == op
        name = _build.minv_kernel(kernels, bf16, op)
        assert name == op + "_bf16"
        assert _build.KERNELS[name][0] == _build.KERNELS[op][0]
        assert _build.KERNELS[name][2] == _build.KERNELS[op][2]
        with pytest.raises(TypeError, match="float16"):
            _build.minv_kernel(kernels, f16, op)
    for pruned in (False, True):
        base = "topk_pruned" if pruned else "topk"
        for kind, suffix in enumerate(("", "_bf16", "_int8")):
            f32_name = topk.kernel_name(pruned, kind)
            assert f32_name == base + suffix
            assert topk.kernel_name(pruned, kind, torch.float32) == f32_name
            name = topk.kernel_name(pruned, kind, torch.bfloat16)
            assert name == base + "_minv_bf16" + suffix
            assert _build.KERNELS[name][2] == _build.KERNELS[f32_name][2]
            assert _build.KERNELS[name][1] == name + "_launch"
            with pytest.raises(TypeError, match="float16"):
                topk.kernel_name(pruned, kind, torch.float16)
    assert all(name in _build.LAUNCHES for name in _build.KERNELS)


def test_the_entry_points_name_the_kernels_the_source_defines():
    """Every bf16-Minv entry of ``_build.KERNELS`` is an ``extern "C"``
    function of its source, and each source widens Minv with the one
    ``widen`` of ``csrc/widen.cuh``."""
    for name, (source, entry, _) in _build.KERNELS.items():
        text = (_build.CSRC / source).read_text()
        assert f'extern "C" int {entry}(' in text, name
    for source in ("choose.cu", "ucb.cu", "rank1.cu", "topk.cu"):
        assert '#include "widen.cuh"' in (_build.CSRC / source).read_text()


@pytest.mark.parametrize("users,K,d", [(1, 1, 1), (12, 20, 25), (11, 20, 32),
                                       (1, 64, 25), (3, 7, 19), (5, 256, 32)])
def test_tile_smem_counts_a_bf16_region(users, K, d):
    """The register tile's shared memory with Minv in bf16: the bf16
    region holds the users' d^2 elements and 7 more for the copy's shift
    (a 16-byte copy moves 8), in whole 16-byte words; the other regions
    are the f32 kernel's."""
    def words(nbytes):
        return -(-nbytes // 16) * 16
    f32 = interact.tile_smem(users, K, d)
    bf16 = interact.tile_smem(users, K, d, 2)
    minv32 = words(4 * (users * d * d + 3))
    minv16 = words(2 * (users * d * d + 7))
    assert f32 - minv32 == bf16 - minv16
    assert minv16 < minv32 or users * d * d <= 1
    assert interact.tile_smem(users, K, d, 4) == f32


@pytest.mark.parametrize("n,K,d,want", [
    (20480, 20, 25, (interact.REGISTER_TILE, 12)),  # the offline rounds
    (256, 64, 25, (interact.REGISTER_TILE, 1)),     # serving's shortlist
    (20480, 20, 32, (interact.REGISTER_TILE, 11)),  # f32: 8 users a block
    (20480, 20, 33, (interact.WARP_PER_USER, 4)),
])
def test_geometry_with_a_bf16_minv(n, K, d, want):
    """The half-size Minv region lets more users share a block where the
    f32 one ran out of shared memory (d = 32), and fits four blocks an
    SM."""
    assert interact.geometry(n, K, d, 132, 2) == want
    variant, users = want
    if variant == interact.REGISTER_TILE and users > 1:
        smem = interact.tile_smem(users, K, d, 2)
        assert interact.TILE_BLOCKS_PER_SM * (smem + interact.BLOCK_RESERVED) \
            <= interact.SM_SMEM
    assert interact.geometry(20480, 20, 32, 132) == (interact.REGISTER_TILE,
                                                     8)
