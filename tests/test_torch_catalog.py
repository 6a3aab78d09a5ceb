"""The port's catalog and item clusters (``repro_torch.core.catalog``,
``repro_torch.core.itemclub``) against ``repro.core.catalog`` and
``repro.core.itemclub`` on the same numpy inputs, on the CPU."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import catalog as jcatalog  # noqa: E402
from repro.core import itemclub as jitemclub  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import catalog, env, itemclub  # noqa: E402
from repro_torch.core.clustering import cb_width  # noqa: E402


def _unit(a):
    return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)


def _assert_catalog_equal(port, ref):
    got = convert.record_to_numpy(port)
    for f in ("emb", "live", "born"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    assert (got.active, got.epoch) == (int(ref.active), int(ref.epoch))


def test_churn_sequence_matches_reference():
    """retire / add / publish / torn publish / staged churn, step by step,
    including ragged ids, a partial fill and slot reuse."""
    rng = np.random.default_rng(0)
    d, N, cap = 5, 6, 10
    emb = _unit(rng.normal(size=(N, d)))
    jc = jcatalog.make_catalog(jnp.asarray(emb), capacity=cap)
    pc = catalog.make_catalog(torch.from_numpy(emb), capacity=cap)
    _assert_catalog_equal(pc, jc)

    def both(fn_j, fn_p, *args):
        return fn_j(jc, *(jnp.asarray(a) for a in args)), fn_p(
            pc, *(torch.from_numpy(np.asarray(a)) for a in args))

    (jc, jn), (pc, pn) = both(jcatalog.retire_items, catalog.retire_items,
                              np.array([1, 4, -1, 99, 1, 7], np.int32))
    assert pn == int(jn) == 2
    assert catalog.staged_churn(pc) == int(jcatalog.staged_churn(jc)) == 2
    assert pc.n_live() == 6                  # staged only
    jc, pc = jcatalog.publish(jc), catalog.publish(pc)
    _assert_catalog_equal(pc, jc)
    fresh = _unit(rng.normal(size=(7, d)))  # more than the 6 free slots
    (jc, js, jn), (pc, ps, pn) = both(jcatalog.add_items, catalog.add_items,
                                      fresh)
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    assert pn == int(jn) == 6 and ps.tolist()[:3] == [1, 4, 6]
    keep = (rng.random(cap) < 0.5).astype(np.float32)
    jc = jcatalog.torn_publish(jc, jnp.asarray(keep))
    pc = catalog.torn_publish(pc, torch.from_numpy(keep))
    _assert_catalog_equal(pc, jc)
    jc, pc = jcatalog.publish(jc), catalog.publish(pc)
    _assert_catalog_equal(pc, jc)
    assert pc.n_live() == int(jc.n_live())


def _region_setup(seed, N, d, R, noise):
    rng = np.random.default_rng(seed)
    c = _unit(rng.normal(size=(R, d)))
    reg = rng.integers(0, R, N)
    emb = _unit(c[reg] + noise * rng.normal(size=(N, d)))
    occ = rng.integers(0, 30, N).astype(np.int32)
    rsum = (rng.random(N) * occ * 0.3).astype(np.float32)
    return emb, reg, occ, rsum


def _features(emb, occ, rsum, beta=1.0):
    rhat = rsum / (1.0 + occ)
    return np.concatenate([emb, beta * rhat[:, None]], 1).astype(np.float64)


@pytest.mark.parametrize("n_anchors", [64, 512])
def test_build_clusters_matches_reference(n_anchors):
    """Labels and layout equal, tile summaries within f32 rounding: with
    64 anchors every slot takes its nearest anchor's label, with 512
    every slot is an anchor.  The inputs keep every anchor pair away from
    the prune threshold, where the two packages may round differently."""
    d, N, tile, gamma = 8, 256, 32, 0.5
    emb, _, occ, rsum = _region_setup(4, N, d, R=4, noise=0.02)
    live = np.ones(N, np.float32)
    live[[3, 100, 101, 200]] = 0
    jc = jcatalog.make_catalog(jnp.asarray(emb))
    jc, _ = jcatalog.retire_items(jc, jnp.asarray(np.nonzero(live == 0)[0]))
    jc = jcatalog.publish(jc)
    pc = convert.record_from_numpy(jc, catalog.Catalog, device="cpu")
    jst = jitemclub.ItemStats(jnp.asarray(occ), jnp.asarray(rsum))
    pst = itemclub.ItemStats(torch.from_numpy(occ), torch.from_numpy(rsum))

    # margin from the CLUB threshold over the anchor pairs
    z = _features(emb, occ, rsum)
    anchors = np.nonzero(live > 0)[0][:n_anchors]
    za = z[anchors]
    dist = np.linalg.norm(za[:, None] - za[None], axis=-1)
    cb = cb_width(torch.from_numpy(occ[anchors])).double().numpy()
    thresh = gamma * (cb[:, None] + cb[None])
    assert np.abs(dist - thresh).min() > 1e-3

    a = jitemclub.build_clusters(jc, jst, tile_items=tile,
                                 n_anchors=n_anchors, gamma=gamma,
                                 kind="reference")
    b = itemclub.build_clusters(pc, pst, tile_items=tile,
                                n_anchors=n_anchors, gamma=gamma)
    got = convert.record_to_numpy(b)
    for f in ("labels", "perm", "live_sorted", "tile_n", "emb_sorted"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(a, f)), err_msg=f)
    for f in ("tile_mu", "tile_r", "tile_xn"):
        np.testing.assert_allclose(getattr(got, f), np.asarray(getattr(a, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    assert int(b.n_clusters) == int(a.n_clusters) and b.epoch == 1
    assert b.tile_items == tile and itemclub.is_fresh(b, pc)


def test_build_clusters_recovers_planted_regions():
    d, N = 16, 1024
    emb, reg, _, _ = _region_setup(11, N, d, R=4, noise=0.01)
    cl = itemclub.build_clusters(catalog.make_catalog(torch.from_numpy(emb)),
                                 tile_items=128, n_anchors=128)
    assert int(cl.n_clusters) == 4
    labels = cl.labels.numpy()
    for r in range(4):
        assert len(set(labels[reg == r])) == 1
    assert len({labels[reg == r][0] for r in range(4)}) == 4
    # the layout is a permutation with every live slot before the dead
    assert sorted(cl.perm.tolist()) == list(range(N))


def test_item_stats_match_reference():
    ids = np.array([3, 3, -1, 9, 7], np.int32)
    r = np.array([1.0, 0.5, 9.0, 9.0, 2.0], np.float32)
    js = jitemclub.observe_served(jitemclub.init_stats(8), jnp.asarray(ids),
                                  jnp.asarray(r))
    ps = itemclub.observe_served(itemclub.init_stats(8, device="cpu"),
                                 torch.from_numpy(ids), torch.from_numpy(r))
    np.testing.assert_array_equal(ps.occ.numpy(), np.asarray(js.occ))
    np.testing.assert_allclose(ps.rsum.numpy(), np.asarray(js.rsum))
    valid = np.array([True, False])
    js2 = jitemclub.observe_served(js, jnp.array([7, 7]), jnp.ones(2),
                                   valid=jnp.asarray(valid))
    ps2 = itemclub.observe_served(ps, torch.tensor([7, 7]), torch.ones(2),
                                  valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(ps2.occ.numpy(), np.asarray(js2.occ))

    # a reclaimed slot resets after the publish that re-seats it
    emb = np.eye(8, 4, dtype=np.float32)
    jc = jcatalog.make_catalog(jnp.asarray(emb))
    pc = catalog.make_catalog(torch.from_numpy(emb))
    jc, _ = jcatalog.retire_items(jc, jnp.array([3]))
    pc, _ = catalog.retire_items(pc, torch.tensor([3]))
    jc, pc = jcatalog.publish(jc), catalog.publish(pc)
    jc, _, _ = jcatalog.add_items(jc, jnp.ones((1, 4)))
    pc, _, _ = catalog.add_items(pc, torch.ones(1, 4))
    jc, pc = jcatalog.publish(jc), catalog.publish(pc)
    j3, p3 = jitemclub.reset_new_slots(js, jc), itemclub.reset_new_slots(ps,
                                                                         pc)
    np.testing.assert_array_equal(p3.occ.numpy(), np.asarray(j3.occ))
    assert int(p3.occ[3]) == 0 and int(p3.occ[7]) == 1


def test_refresh_clusters_is_lazy_until_a_publish():
    emb, _, _, _ = _region_setup(2, 128, 6, R=3, noise=0.05)
    pc = catalog.make_catalog(torch.from_numpy(emb))
    cl = itemclub.build_clusters(pc, tile_items=32)
    assert itemclub.refresh_clusters(cl, pc) is cl
    pc, _ = catalog.retire_items(pc, torch.arange(0, 128, 2))
    pc = catalog.publish(pc)
    assert not itemclub.is_fresh(cl, pc)
    cl2 = itemclub.refresh_clusters(cl, pc)
    assert cl2.epoch == 1 and cl2.tile_items == 32
    assert int(cl2.tile_n.sum()) == 64


def test_catalog_env_serves_the_synthetic_users():
    """The user side of ``make_catalog_env(seed)`` is
    ``make_synthetic_env(seed)``; items are unit rows in their regions."""
    e, labels = env.make_catalog_env(3, 40, 6, 4, 300, n_regions=5,
                                     device="cpu")
    s, slabels = env.make_synthetic_env(3, 40, 6, 4, 20, 0.05, device="cpu")
    assert torch.equal(e.theta, s.theta) and torch.equal(labels, slabels)
    emb = env.catalog_embeddings(e)
    assert emb.shape == (300, 6) and e.n_items == 300 and e.n_phases == 1
    torch.testing.assert_close(torch.linalg.norm(emb, dim=-1),
                               torch.ones(300))
    assert int(e.item_region.max()) < 5
    g = torch.Generator().manual_seed(0)
    fresh, regions = env.sample_churn_items(e, g, 7, region=2)
    assert fresh.shape == (7, 6) and (regions == 2).all()
    # a flash crowd lands next to its region's centroid
    assert bool((fresh @ e.region_centroids[0, 2] > 0.9).all())
