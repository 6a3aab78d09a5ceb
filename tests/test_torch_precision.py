"""Reduced-precision serving on the port (``core.backend.Precision``,
bf16 ``Minv`` state, bf16 and int8 catalog banks with per-slot scales)
against ``repro`` on the CPU, from numpy inputs:

  * ``Precision`` and ``resolve_precision``: the presets, the order
    (argument, ``REPRO_PRECISION``, f32) and the errors;
  * ``make_catalog`` / ``add_items`` / ``retire_items`` / ``publish``
    under bf16 and int8: codes and scales bit-equal to ``repro``'s
    (carried across by ``convert.catalog_from_numpy``), and int8 scales
    surviving churn, publish and slot reclaim;
  * the plain versions of the kernel variants against ``repro``'s Pallas
    kernels in interpret mode: ``rank1_update_inv`` on a bf16 ``Minv``
    (within one bf16 ulp), ``topk`` / ``topk_pruned`` over bf16 and
    int8 items (the same ids, scores within f32 rtol 1e-6);
  * ``build_clusters``' widened tile radii against ``repro``'s;
  * bf16 and int8 sessions against ``repro``'s on the same traffic, its
    Bernoulli draws on a tape: the same items, ``Minv`` within one bf16
    ulp; ``Precision.f32`` bit-identical to the default session; the
    pruned shortlist equal to the unpruned one; the counterfactual
    choice-flip rate (``benchmarks/bench_precision.py``'s method) at
    most 0.01."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import serve as jserve  # noqa: E402
from repro.core import backend as jbackend  # noqa: E402
from repro.core import catalog as jcatalog  # noqa: E402
from repro.core import env as jenv  # noqa: E402
from repro.core.types import BanditHyper as JHyper  # noqa: E402
from repro.kernels.rank1 import ops as jrank1  # noqa: E402
from repro.kernels.topk import ops as jtopk  # noqa: E402
from repro_torch import convert, serve  # noqa: E402
from repro_torch.core import backend, catalog, env  # noqa: E402
from repro_torch.core.types import BanditHyper  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.rank1 import ops as rank1  # noqa: E402
from repro_torch.kernels.topk import ops as topk  # noqa: E402
from repro_torch.kernels.topk import ref as topk_ref  # noqa: E402

D, K_SHORT, K = 16, 16, 8
N_USERS, N_ITEMS, B = 48, 512, 24
REFRESH = 3 * B              # stage 2 after every third batch
HYPER = dict(alpha=0.05, sigma=4, max_rounds=1, gamma=1.5, n_candidates=K)
JHYPER, PHYPER = JHyper(**HYPER), BanditHyper(**HYPER)
REDUCED = ("bf16", "int8")


def _unit(a):
    return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)


_RNG = np.random.default_rng(24)
_CENT = _unit(_RNG.normal(size=(6, D)))
THETA = _unit(_CENT[_RNG.integers(0, 6, N_USERS)]
              + 0.1 * _RNG.normal(size=(N_USERS, D)))
ITEMS = _unit(_CENT[_RNG.integers(0, 6, N_ITEMS)]
              + 0.3 * _RNG.normal(size=(N_ITEMS, D)))
JTHETA, PTHETA = jnp.asarray(THETA), torch.from_numpy(THETA)


def jreward(key, uids, ctx, choice):
    return jenv.step_rewards(key, JTHETA[uids], ctx, choice)


def uniforms(i, n=B):
    """The reference's Bernoulli draws of ``jreward`` at key ``i``."""
    return torch.from_numpy(np.array(
        jax.random.uniform(jax.random.PRNGKey(i), (n,))))


def preward(i, uids, ctx, choice):
    th = PTHETA[uids.clamp(0, N_USERS - 1).long()]
    return env.step_rewards(uniforms(i, uids.shape[0]), th, ctx, choice)


def batch(i):
    return np.random.default_rng(100 + i).permutation(N_USERS)[:B].astype(
        np.int32)


def _to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def _catalogs(prec, **kw):
    jc = jserve.make_catalog(jnp.asarray(ITEMS), precision=prec, **kw)
    return jc, convert.catalog_from_numpy(_to_numpy(jc), device="cpu")


def _ordered(t: torch.Tensor) -> torch.Tensor:
    """bf16 values as ordered ints: one apart = one ulp apart."""
    bits = t.contiguous().view(torch.int16).to(torch.int32)
    return torch.where(bits >= 0, bits, -32768 - bits)


def assert_bf16_ulp(got: torch.Tensor, want) -> None:
    """``got`` (bf16) within one bf16 ulp of ``want`` at every element."""
    if not isinstance(want, torch.Tensor):
        want = convert._tensor(want, "cpu")
    assert got.dtype == want.dtype == torch.bfloat16
    diff = (_ordered(got) - _ordered(want)).abs()
    assert int(diff.max()) <= 1, f"{int((diff > 1).sum())} elements > 1 ulp"


def _assert_catalog_equal(p, j):
    """Every bank field bit-equal to the reference's."""
    jn = _to_numpy(j)
    for f in ("emb", "live", "born", "scale"):
        got, want = getattr(p, f), getattr(jn, f)
        if want.dtype.name == "bfloat16":
            assert_bf16_ulp(got, want)
            assert torch.equal(got, convert._tensor(want, "cpu")), f
        else:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f)
    assert (p.active, p.epoch) == (int(j.active), int(j.epoch))


# ---------------------------------------------------------------------------
# Precision and resolve_precision
# ---------------------------------------------------------------------------


def test_presets_match_reference():
    for name in ("f32", "bf16", "int8"):
        got = getattr(backend.Precision, name)
        assert tuple(got) == tuple(getattr(jbackend.Precision, name))
        assert backend.resolve_precision(name) == got
    assert backend.Precision.bf16.torch_state == torch.bfloat16
    assert backend.Precision.int8.torch_catalog == torch.int8
    assert backend.Precision.f32.torch_state == torch.float32


def test_resolve_precision_order(monkeypatch):
    monkeypatch.delenv("REPRO_PRECISION", raising=False)
    assert backend.resolve_precision(None) == backend.Precision.f32
    monkeypatch.setenv("REPRO_PRECISION", "int8")
    assert backend.resolve_precision(None) == backend.Precision.int8
    assert jbackend.resolve_precision(None) == jbackend.Precision.int8
    # the argument comes before the variable
    assert backend.resolve_precision("bf16") == backend.Precision.bf16
    custom = backend.Precision(state_dtype="bf16", catalog_dtype="int8",
                               scale_block=64)
    assert backend.resolve_precision(custom) is custom
    # and carries into the engines and the sessions
    assert backend.BackendConfig.create().precision == backend.Precision.int8
    s = serve.OnlineBandit.create(8, 3, BanditHyper(n_candidates=3),
                                  device="cpu")
    assert s.policy.cfg.precision == backend.Precision.int8
    assert s.state.Minv.dtype == torch.bfloat16
    monkeypatch.setenv("REPRO_PRECISION", "")
    assert backend.resolve_precision(None) == backend.Precision.f32


@pytest.mark.parametrize("bad", [
    "fp16", 3, backend.Precision(state_dtype="int8"),
    backend.Precision(catalog_dtype="fp8"),
    backend.Precision(accum_dtype="bf16"),
    backend.Precision(scale_block=0)])
def test_resolve_precision_errors(bad):
    jbad = (jbackend.Precision(*bad) if isinstance(bad, backend.Precision)
            else bad)
    with pytest.raises((ValueError, TypeError)) as want:
        jbackend.resolve_precision(jbad)
    with pytest.raises(want.type):
        backend.resolve_precision(bad)


# ---------------------------------------------------------------------------
# catalogs: quantization, churn, publish, reclaim
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prec", ["f32", "bf16", "int8"])
def test_make_catalog_matches_reference(prec):
    p = jbackend.Precision(*jbackend.resolve_precision(prec)._replace(
        scale_block=64))
    jc, pc = _catalogs(p, capacity=N_ITEMS + 40)
    mine = catalog.make_catalog(torch.from_numpy(ITEMS),
                                capacity=N_ITEMS + 40,
                                precision=backend.Precision(*p))
    _assert_catalog_equal(mine, jc)
    _assert_catalog_equal(pc, jc)
    np.testing.assert_array_equal(
        catalog.dequantize(mine.serving).numpy(),
        np.asarray(jcatalog.dequantize(jc.serving)))
    assert mine.serving.emb.dtype == {"f32": torch.float32,
                                      "bf16": torch.bfloat16,
                                      "int8": torch.int8}[prec]


@pytest.mark.parametrize("prec", REDUCED)
def test_churn_matches_reference(prec):
    """Retire, add (with a partial fill), publish, reclaim and a torn
    publish, each step's banks bit-equal to the reference's."""
    jc, pc = _catalogs(prec, capacity=N_ITEMS + 8)
    rng = np.random.default_rng(5)
    retired = np.arange(10, 30, dtype=np.int32)
    new = (3.0 * rng.normal(size=(12, D))).astype(np.float32)
    jc, jn = jcatalog.retire_items(jc, jnp.asarray(retired))
    pc, pn = catalog.retire_items(pc, torch.from_numpy(retired))
    assert pn == int(jn)
    jc, js, ja = jcatalog.add_items(jc, jnp.asarray(new))
    pc, ps, pa = catalog.add_items(pc, torch.from_numpy(new))
    assert pa == int(ja)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    assert catalog.staged_churn(pc) == int(jcatalog.staged_churn(jc))
    _assert_catalog_equal(pc, jc)
    jc, pc = jcatalog.publish(jc), catalog.publish(pc)
    _assert_catalog_equal(pc, jc)
    # reclaim: the next add claims retired slots with its own scales
    more = (0.5 * rng.normal(size=(40, D))).astype(np.float32)
    jc, js, _ = jcatalog.add_items(jc, jnp.asarray(more))
    pc, ps, _ = catalog.add_items(pc, torch.from_numpy(more))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    keep = rng.random(pc.capacity) < 0.5
    jc = jcatalog.torn_publish(jc, jnp.asarray(keep))
    pc = catalog.torn_publish(pc, torch.from_numpy(keep))
    _assert_catalog_equal(pc, jc)


def test_int8_scales_survive_churn_publish_and_reclaim():
    """``repro`` ``tests/test_precision.py``'s scale round trip on the
    port: untouched slots keep codes and scales bit-exactly across the
    swap, churn-added rows get their own per-row scales within the
    quantization bound, reclaimed slots take the new row's scale, and a
    no-churn publish round trip is the identity."""
    prec = backend.Precision(state_dtype="bf16", catalog_dtype="int8",
                             scale_block=64)
    cat = catalog.make_catalog(torch.from_numpy(ITEMS),
                               capacity=N_ITEMS + 32, precision=prec)
    deq = catalog.dequantize(cat.serving).numpy()
    orig = np.zeros_like(deq)
    orig[:N_ITEMS] = ITEMS
    sc = cat.serving.scale.numpy()
    assert np.all(np.abs(deq - orig) <= sc[:, None] / 2 + 1e-7)

    retired = torch.arange(10, 20, dtype=torch.int32)
    cat1, n_ret = catalog.retire_items(cat, retired)
    new_rows = torch.from_numpy(
        3.0 * np.random.default_rng(5).normal(size=(6, D)).astype(np.float32))
    cat1, slots, n_add = catalog.add_items(cat1, new_rows)
    assert n_ret == 10 and n_add == 6
    before, cat2 = cat1.serving, catalog.publish(cat1)
    after = cat2.serving
    touched = np.zeros(cat.capacity, bool)
    touched[retired.numpy()] = True
    touched[slots.numpy()] = True
    for f in ("emb", "scale"):
        np.testing.assert_array_equal(getattr(before, f).numpy()[~touched],
                                      getattr(after, f).numpy()[~touched])
    deq2 = catalog.dequantize(after).numpy()
    for i, s in enumerate(slots.tolist()):
        want = max(float(new_rows[i].abs().max()), 1e-8) / 127.0
        assert np.isclose(float(after.scale[s]), want, rtol=1e-6)
        assert np.all(np.abs(deq2[s] - new_rows[i].numpy())
                      <= want / 2 + 1e-6)
    cat3, slots2, _ = catalog.add_items(cat2, 0.5 * torch.from_numpy(
        np.random.default_rng(6).normal(size=(4, D)).astype(np.float32)))
    assert set(slots2.tolist()) <= set(range(10, 20))
    cat3 = catalog.publish(cat3)
    s0 = int(slots2[0])
    assert float(cat3.serving.scale[s0]) != float(cat2.serving.scale[s0])
    cat4 = catalog.publish(catalog.publish(cat3))
    for f in ("emb", "scale"):
        assert torch.equal(getattr(cat3.serving, f), getattr(cat4.serving, f))
    # item_shard slices the scales with the rest
    half = catalog.item_shard(cat4, 1, 2)
    assert torch.equal(half.scale, cat4.scale[:, cat4.capacity // 2:])


# ---------------------------------------------------------------------------
# the kernel variants' plain versions against repro's Pallas kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,d", [(37, 25), (64, 16), (5, 3)])
def test_rank1_bf16_matches_pallas_interpret(n, d):
    rng = np.random.default_rng(n * d)
    A = 0.1 * rng.normal(size=(n, d, d))
    Minv32 = np.linalg.inv(np.eye(d) + A @ A.transpose(0, 2, 1)).astype(
        np.float32)
    jM = jnp.asarray(Minv32).astype(jnp.bfloat16)
    b = rng.normal(size=(n, d)).astype(np.float32)
    x = rng.normal(size=(n, d)).astype(np.float32)
    r = rng.random(n).astype(np.float32)
    mask = rng.random(n) < 0.7
    mask[0], mask[-1] = True, False
    want_M, want_b = jrank1.rank1_update_inv(
        jM, *(jnp.asarray(a) for a in (b, x, r, mask)), use_pallas=True,
        interpret=True)
    assert want_M.dtype == jnp.bfloat16
    M0 = convert._tensor(np.asarray(jM), "cpu")
    Mp, bp = M0.clone(), torch.from_numpy(b.copy())
    got_M, got_b = rank1.rank1_update_inv(Mp, bp, torch.from_numpy(x),
                                          torch.from_numpy(r),
                                          torch.from_numpy(mask))
    assert got_M is Mp and got_M.dtype == torch.bfloat16
    assert_bf16_ulp(got_M, np.asarray(want_M))
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=0,
                               atol=1e-6)
    off = torch.from_numpy(~mask)
    assert torch.equal(got_M[off], M0[off])          # bit-identical
    assert torch.equal(got_b[off], torch.from_numpy(b)[off])
    assert not torch.equal(got_M[~off], M0[~off])
    assert rank1.INV_KERNELS[torch.bfloat16] == "rank1_update_inv_bf16"


def _stats(rng, n, d):
    w = rng.normal(size=(n, d)).astype(np.float32)
    A = 0.1 * rng.normal(size=(n, d, d))
    Minv = (np.eye(d) + A @ A.transpose(0, 2, 1)).astype(np.float32)
    occ = rng.integers(0, 50, n).astype(np.int32)
    return w, Minv, occ


def _quantized_items(prec, x):
    """``x`` stored as the reference's bank of ``prec``: (reference
    items, reference scales or None, port items, port scales or None)."""
    jc = jserve.make_catalog(jnp.asarray(x),
                             precision=jbackend.Precision(
                                 *jbackend.resolve_precision(prec)
                                 ._replace(scale_block=32)))
    js = jc.serving.scale if prec == "int8" else None
    pc = convert.catalog_from_numpy(_to_numpy(jc), device="cpu")
    return (jc.serving.emb, js, pc.serving.emb,
            pc.serving.scale if prec == "int8" else None)


def _assert_shortlists(got, want):
    s, i = got
    js, ji = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(i.numpy(), ji)
    fin = np.isfinite(js)
    np.testing.assert_array_equal(np.isfinite(s.numpy()), fin)
    np.testing.assert_allclose(s.numpy()[fin], js[fin], rtol=1e-6, atol=0)


@pytest.mark.parametrize("prec", REDUCED)
@pytest.mark.parametrize("n,d,N,k", [(37, 25, 700, 16), (8, 16, 512, 64)])
def test_topk_matches_pallas_interpret(prec, n, d, N, k):
    rng = np.random.default_rng(n + N)
    w, Minv, occ = _stats(rng, n, d)
    x = _unit(rng.normal(size=(N, d)))
    live = (rng.random(N) > 0.2).astype(np.float32)
    jx, jsc, px, psc = _quantized_items(prec, x)
    want = jtopk.topk(*(jnp.asarray(a) for a in (w, Minv, occ)), jx,
                      jnp.asarray(live), 0.3, k, use_pallas=True,
                      block_users=8, block_items=128, interpret=True,
                      scales=jsc)
    got = topk.topk(*(torch.from_numpy(a) for a in (w, Minv, occ)), px,
                    torch.from_numpy(live), 0.3, k, scales=psc)
    _assert_shortlists(got, want)
    # the plain version scores the dequantized items: the same shortlist
    # as the f32 plain version over them
    deq = topk_ref.dequantize_rows(px, psc)
    again = topk.topk(*(torch.from_numpy(a) for a in (w, Minv, occ)), deq,
                      torch.from_numpy(live), 0.3, k)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


@pytest.mark.parametrize("prec", REDUCED)
def test_topk_pruned_matches_pallas_interpret(prec):
    n, d, N, tile, k = 16, 16, 1024, 64, 16
    rng = np.random.default_rng(3)
    w, Minv, occ = _stats(rng, n, d)
    c = _unit(rng.normal(size=(8, d)))
    w = (2.0 * c[rng.integers(0, 8, n)]).astype(np.float32)
    x = _unit(c[np.arange(N) // (N // 8)] + 0.05 * rng.normal(size=(N, d)))
    live = (rng.random(N) > 0.1).astype(np.float32)
    ids = rng.permutation(N).astype(np.int32)
    jx, jsc, px, psc = _quantized_items(prec, x)
    deq = topk_ref.dequantize_rows(px, psc)
    T = N // tile
    et, lt = deq.view(T, tile, d), torch.from_numpy(live).view(T, tile)
    cnt = lt.sum(1)
    mu = (et * lt[..., None]).sum(1) / cnt.clamp_min(1)[:, None]
    r = torch.where(lt > 0, torch.linalg.norm(et - mu[:, None], dim=-1),
                    0.0).amax(1)
    xn = torch.where(lt > 0, torch.linalg.norm(et, dim=-1), 0.0).amax(1)
    stats = [torch.from_numpy(a) for a in (w, Minv, occ)]
    tb = topk_ref.tile_bounds(*stats, 0.3, mu, r, xn, cnt.to(torch.int32))
    want = jtopk.topk_pruned(*(jnp.asarray(a) for a in (w, Minv, occ)), jx,
                             jnp.asarray(live), jnp.asarray(ids), 0.3, k,
                             jnp.asarray(tb.numpy()), use_pallas=True,
                             block_users=8, interpret=True, scales=jsc)
    s, i, skipped, total = topk.topk_pruned(
        *stats, px, torch.from_numpy(live), torch.from_numpy(ids), 0.3, k,
        tb, scales=psc)
    _assert_shortlists((s, i), want[:2])
    assert skipped > 0 and total == T * 2
    # bit-equal to the unpruned shortlist over the same rows by slot id
    inv = torch.argsort(torch.from_numpy(ids).long())
    su, iu = topk.topk(*stats, px[inv], torch.from_numpy(live)[inv], 0.3, k,
                       scales=None if psc is None else psc[inv])
    assert torch.equal(s, su) and torch.equal(i, iu)


def test_topk_refuses_mismatched_scales():
    w, Minv, occ = (torch.from_numpy(a) for a in
                    _stats(np.random.default_rng(0), 4, 8))
    live = torch.ones(64)
    x = torch.randn(64, 8)
    sc = torch.ones(64)
    with pytest.raises(ValueError, match="scales"):
        topk.topk(w, Minv, occ, x.to(torch.int8), live, 0.3, 4)
    with pytest.raises(ValueError, match="no scales"):
        topk.topk(w, Minv, occ, x.bfloat16(), live, 0.3, 4, scales=sc)
    with pytest.raises(TypeError, match="dtype"):
        topk.topk(w, Minv, occ, x.half(), live, 0.3, 4)
    assert topk.item_kind(x.to(torch.int8), sc) == 2
    assert topk.kernel_name(True, 1) == "topk_pruned_bf16"
    assert topk.kernel_name(False, 2) == "topk_int8"


# ---------------------------------------------------------------------------
# item clusters over quantized banks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prec", REDUCED)
def test_build_clusters_widening_matches_reference(prec):
    jc, pc = _catalogs(prec)
    jcl = jserve.build_clusters(jc, tile_items=64, n_anchors=64,
                                kind="reference")
    pcl = serve.build_clusters(pc, tile_items=64, n_anchors=64)
    np.testing.assert_array_equal(pcl.perm.numpy(), np.asarray(jcl.perm))
    assert pcl.emb_sorted.dtype == pc.emb.dtype          # stored dtype
    assert torch.equal(pcl.emb_sorted, convert._tensor(
        np.asarray(jcl.emb_sorted), "cpu"))
    np.testing.assert_array_equal(pcl.scale_sorted.numpy(),
                                  np.asarray(jcl.scale_sorted))
    for f in ("tile_mu", "tile_r", "tile_xn"):
        np.testing.assert_allclose(getattr(pcl, f).numpy(),
                                   np.asarray(getattr(jcl, f)), rtol=1e-5,
                                   atol=1e-6, err_msg=f)
    np.testing.assert_array_equal(pcl.tile_n.numpy(), np.asarray(jcl.tile_n))
    # the widening is there: the f32 bank's radii are strictly smaller
    f32 = serve.build_clusters(serve.make_catalog(
        torch.from_numpy(ITEMS), precision="f32"), tile_items=64,
        n_anchors=64)
    assert torch.equal(f32.perm, pcl.perm)
    assert bool((pcl.tile_xn > f32.tile_xn).all())


# ---------------------------------------------------------------------------
# sessions against repro's
# ---------------------------------------------------------------------------


def _sessions(prec, policy="distclub"):
    j = jserve.OnlineBandit.create(N_USERS, D, JHYPER, policy=policy,
                                   refresh_every=REFRESH,
                                   backend="reference", precision=prec)
    p = serve.OnlineBandit.create(N_USERS, D, PHYPER, policy=policy,
                                  refresh_every=REFRESH, precision=prec,
                                  device="cpu")
    return j, p


@pytest.mark.parametrize("policy", ["distclub", "linucb"])
@pytest.mark.parametrize("prec", REDUCED)
def test_session_matches_reference(prec, policy):
    jc, pc = _catalogs(prec)
    js, ps = _sessions(prec, policy)
    assert ps.state.Minv.dtype == torch.bfloat16
    pcl = serve.build_clusters(pc, tile_items=64, n_anchors=64)
    pp = ps
    for i in range(6):
        u = batch(i)
        js, jit, jm = jserve.step_catalog(js, jax.random.PRNGKey(i),
                                          jnp.asarray(u), jc, jreward,
                                          k_short=K_SHORT)
        ps, pit, pm = serve.step_catalog(ps, i, torch.from_numpy(u), pc,
                                         preward, k_short=K_SHORT)
        pp, ppit, _, rmet = serve.step_catalog(
            pp, i, torch.from_numpy(u), pc, preward, k_short=K_SHORT,
            clusters=pcl)
        np.testing.assert_array_equal(pit.numpy(), np.asarray(jit))
        assert torch.equal(ppit, pit) and rmet.pruned_active == 1
        assert float(pm.reward) == float(jm.reward)
    jst = _to_numpy(js.state)
    assert_bf16_ulp(ps.state.Minv, jst.Minv)
    np.testing.assert_allclose(ps.state.b.numpy(), jst.b, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ps.state.occ.numpy(), jst.occ)
    if policy == "distclub":           # two refreshes fired
        assert_bf16_ulp(ps.state.uMcinv, jst.uMcinv)
        np.testing.assert_array_equal(ps.state.labels.numpy(), jst.labels)
        assert float(ps.state.comm_bytes) > 0
    for x, y in zip(ps.state, pp.state):
        assert torch.equal(x, y)


@pytest.mark.parametrize("prec", REDUCED)
def test_slate_session_and_from_offline_match_reference(prec):
    """The slate path and a warm start: ``from_offline`` casts the f32
    offline state down to the session's state dtype, as ``repro``'s."""
    js, ps = _sessions(prec)
    for i in range(3):
        u = batch(i)
        c = _unit(np.random.default_rng(200 + i).normal(size=(B, K, D)))
        js, jch, _ = jserve.step(js, jax.random.PRNGKey(i), jnp.asarray(u),
                                 jnp.asarray(c), jreward)
        ps, pch, _ = serve.step(ps, i, torch.from_numpy(u),
                                torch.from_numpy(c), preward)
        np.testing.assert_array_equal(pch.numpy(), np.asarray(jch))
    assert_bf16_ulp(ps.state.Minv, np.asarray(js.state.Minv))
    offline = serve.to_distclub_state(ps.state, PHYPER, D)
    assert offline.lin.Minv.dtype == torch.float32
    warm = serve.OnlineBandit.from_offline(offline, PHYPER, precision=prec)
    assert warm.state.Minv.dtype == warm.state.uMcinv.dtype == torch.bfloat16
    assert torch.equal(warm.state.Minv, offline.lin.Minv.bfloat16())


def test_f32_precision_is_bit_identical_to_default():
    jc, pc = _catalogs(None)
    pc32 = convert.catalog_from_numpy(_to_numpy(jserve.make_catalog(
        jnp.asarray(ITEMS), precision="f32")), device="cpu")
    _assert_catalog_equal(pc32, jc)
    a = serve.OnlineBandit.create(N_USERS, D, PHYPER, refresh_every=REFRESH,
                                  device="cpu")
    b = serve.OnlineBandit.create(N_USERS, D, PHYPER, refresh_every=REFRESH,
                                  precision="f32", device="cpu")
    assert b.state.Minv.dtype == torch.float32
    for i in range(4):
        u = torch.from_numpy(batch(i))
        a, ia, _ = serve.step_catalog(a, i, u, pc, preward, k_short=K_SHORT)
        b, ib, _ = serve.step_catalog(b, i, u, pc32, preward,
                                      k_short=K_SHORT)
        assert torch.equal(ia, ib)
    for x, y in zip(a.state, b.state):
        assert torch.equal(x, y)


@pytest.mark.parametrize("prec", REDUCED)
def test_pruned_retrieval_exact_under_quantized_banks(prec):
    """``repro`` ``tests/test_precision.py``'s pruned check on the port:
    the quantized tile summaries widen conservatively, so the pruned
    serve equals the unpruned one, while tiles are really skipped on a
    region-structured catalog."""
    e, _ = env.make_catalog_env(0, N_USERS, D, 4, N_ITEMS,
                                item_noise_scale=0.02, device="cpu")
    emb = env.catalog_embeddings(e)
    sess = serve.OnlineBandit.create(N_USERS, D, PHYPER, precision=prec,
                                     device="cpu")
    cat = serve.make_catalog(emb, precision=prec)

    def reward(i, uids, ctx, choice):
        return env.step_rewards(uniforms(i, uids.shape[0]),
                                e.theta[uids.long()], ctx, choice)

    for t in range(12):
        sess, _, _ = serve.step_catalog(sess, t, torch.from_numpy(batch(t)),
                                        cat, reward, k_short=K_SHORT)
    cl = serve.build_clusters(cat, tile_items=32, n_anchors=64)
    u = torch.arange(B, dtype=torch.int32)
    plain, _, _ = serve.recommend_catalog(sess, u, cat, k_short=K_SHORT)
    pruned, _, _, rmet = serve.recommend_catalog(sess, u, cat,
                                                 k_short=K_SHORT, clusters=cl)
    assert torch.equal(plain, pruned)
    assert rmet.skip_ratio() > 0.0


def test_choice_flip_rate_bounded():
    """``benchmarks/bench_precision.py``'s counterfactual method at a small
    size: the f32 session drives the one trajectory; after the warm-up
    each batch's f32 decision is compared with the decision from the same
    state cast down against the quantized catalog.  bf16 and int8 flip at
    most 1% of the choices, and launch no kernel on the CPU."""
    oracle = serve.OnlineBandit.create(N_USERS, D, PHYPER, device="cpu")
    cat = serve.make_catalog(torch.from_numpy(ITEMS))
    probes = {p: (serve.OnlineBandit.create(N_USERS, D, PHYPER,
                                            precision=p, device="cpu"),
                  serve.make_catalog(torch.from_numpy(ITEMS), precision=p))
              for p in REDUCED}
    warm, meas = 24, 12
    flips = dict.fromkeys(probes, 0)
    _build.reset_launches()
    for t in range(warm + meas):
        u = torch.from_numpy(batch(t))
        if t >= warm:
            want, _, _ = serve.recommend_catalog(oracle, u, cat,
                                                 k_short=K_SHORT)
            for p, (rs, catp) in probes.items():
                st = oracle.state._replace(
                    Minv=oracle.state.Minv.bfloat16(),
                    uMcinv=oracle.state.uMcinv.bfloat16())
                got, _, _ = serve.recommend_catalog(
                    dataclasses.replace(rs, state=st), u, catp,
                    k_short=K_SHORT)
                flips[p] += int((got != want).sum())
        oracle, _, _ = serve.step_catalog(oracle, t, u, cat, preward,
                                          k_short=K_SHORT)
    assert all(v == 0 for v in _build.LAUNCHES.values())
    for p, f in flips.items():
        assert f / (meas * B) <= 0.01, (p, f, meas * B)
