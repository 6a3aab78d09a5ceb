"""The port's serving sessions (``repro_torch.serve``) against
``repro.serve`` on the CPU: both packages serve the same users, slates
and catalog from numpy inputs, with the reference's Bernoulli draws
replayed to the port as a tape of uniforms.  Choices and items must be
equal, LinUCB statistics within 1e-5 and clusters equal after a refresh,
for each ported policy, on the slate path, the catalog path (unpruned and
cluster-pruned), warm-started from an offline run, and under delayed,
duplicated and churned feedback.

dccb: its refresh is a gossip round whose peers the port draws with the
reference's own draw (``jax.random.categorical`` at the refresh key of
``repro.serve.session._schedule_refresh``), and its slates and items are
scaled per slot, because DCCB scores with ``w = 0``, ``Minv = I`` until
a user's first buffered update is popped, and unit-norm candidates then
tie to the last ulp (tests/test_torch_dccb.py)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import serve as jserve  # noqa: E402
from repro.core import backend as jbackend  # noqa: E402
from repro.core import distclub as jdistclub  # noqa: E402
from repro.core import env as jenv  # noqa: E402
from repro.core import env_ops as jenv_ops  # noqa: E402
from repro.core.types import BanditHyper as JHyper  # noqa: E402
from repro_torch import convert, serve  # noqa: E402
from repro_torch.core import env  # noqa: E402
from repro_torch.core.types import BanditHyper  # noqa: E402
from repro_torch.serve import pending  # noqa: E402

N_USERS, D, K, B = 24, 6, 8, 12
N_ITEMS, K_SHORT, TILE = 256, 8, 32
REFRESH = 36                 # stage 2 fires after every third batch
HYPER = dict(alpha=0.3, sigma=4, max_rounds=1, gamma=1.5, n_candidates=K,
             buffer_size=3)
JHYPER, PHYPER = JHyper(**HYPER), BanditHyper(**HYPER)


def _unit(a):
    return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)


_RNG = np.random.default_rng(7)
_CENT = _unit(_RNG.normal(size=(4, D)))
THETA = _unit(_CENT[_RNG.integers(0, 4, N_USERS)]
              + 0.1 * _RNG.normal(size=(N_USERS, D)))
ITEMS = _unit(_CENT[_RNG.integers(0, 4, N_ITEMS)]
              + 0.3 * _RNG.normal(size=(N_ITEMS, D)))
JTHETA, PTHETA = jnp.asarray(THETA), torch.from_numpy(THETA)
_SERVED_KEY = [0]          # the key of the batch the port serves last


def jreward(key, uids, ctx, choice):
    return jenv.step_rewards(key, JTHETA[uids], ctx, choice)


def uniforms(i, n=B):
    """The reference's Bernoulli draws of ``jreward`` at key ``i``."""
    return torch.from_numpy(np.array(
        jax.random.uniform(jax.random.PRNGKey(i), (n,))))


def preward(i, uids, ctx, choice):
    _SERVED_KEY[0] = i
    th = PTHETA[uids.clamp(0, N_USERS - 1).long()]
    return env.step_rewards(uniforms(i, uids.shape[0]), th, ctx, choice)


def batch(i, pad=False):
    """Batch ``i``'s user ids: with duplicates, and with padding rows
    (-1 and out of range) when ``pad``."""
    rng = np.random.default_rng(100 + i)
    u = rng.integers(0, N_USERS, B).astype(np.int32)
    u[3] = u[0]
    if pad:
        u[[5, 9]] = [-1, N_USERS + 3]
    return u


def contexts(i, policy=None):
    c = _unit(np.random.default_rng(200 + i).normal(size=(B, K, D)))
    if policy == "dccb":
        c = c * (1 + np.arange(K, dtype=np.float32) / (2 * K))[:, None]
    return c


def _reference_peers(seed, step, adj):
    """The dccb refresh's draw in ``repro.serve``: categorical over the
    neighbours at ``fold_in(fold_in(key, 1), lifetime interactions)``,
    ``key`` being the served batch's."""
    k = jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(_SERVED_KEY[0]), 1), step)
    logits = jnp.where(jnp.asarray(adj.numpy()), 0.0, -jnp.inf)
    return torch.from_numpy(np.array(jax.random.categorical(k, logits)))


def _sessions(policy, **kw):
    j = jserve.OnlineBandit.create(N_USERS, D, JHYPER, policy=policy,
                                   refresh_every=REFRESH,
                                   backend="reference", **kw)
    p = serve.OnlineBandit.create(N_USERS, D, PHYPER, policy=policy,
                                  refresh_every=REFRESH, device="cpu", **kw)
    if policy == "dccb":
        p = dataclasses.replace(p, policy=p.policy._replace(
            peers_fn=_reference_peers))
    return j, p


_CLOSE = ("Minv", "b", "uMcinv", "ubc", "umean_occ", "comm_bytes", "Mw",
          "bw", "Mbuf", "bbuf")


def _assert_record_close(got, j):
    for f in got._fields:
        g = getattr(got, f)
        if hasattr(g, "_fields"):            # dccb's nested core record
            _assert_record_close(g, getattr(j, f))
        elif f in _CLOSE:
            np.testing.assert_allclose(g, np.asarray(getattr(j, f)), rtol=0,
                                       atol=1e-5, err_msg=f)
        else:
            np.testing.assert_array_equal(g, np.asarray(getattr(j, f)),
                                          err_msg=f)


def _assert_state_close(p, j):
    _assert_record_close(convert.record_to_numpy(p), j)


def _leaves(record):
    for v in record:
        if hasattr(v, "_fields"):
            yield from _leaves(v)
        else:
            yield v


def _assert_states_equal(a, b):
    for x, y in zip(_leaves(a), _leaves(b)):
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else x == y)


def _catalogs(policy=None):
    items = ITEMS
    if policy == "dccb":
        items = items * (1 + np.arange(N_ITEMS, dtype=np.float32)
                         / (2 * N_ITEMS))[:, None]
    jc = jserve.make_catalog(jnp.asarray(items))
    return jc, convert.record_from_numpy(jc, serve.Catalog, device="cpu")


@pytest.mark.parametrize("policy", ["distclub", "club", "linucb", "dccb"])
def test_slate_step_recommend_observe_match_reference(policy):
    js, ps = _sessions(policy)
    for i in range(6):
        u, c = batch(i, pad=i % 2 == 1), contexts(i, policy)
        js, jch, jm = jserve.step(js, jax.random.PRNGKey(i), jnp.asarray(u),
                                  jnp.asarray(c), jreward)
        ps, pch, pm = serve.step(ps, i, torch.from_numpy(u),
                                 torch.from_numpy(c), preward)
        np.testing.assert_array_equal(pch.numpy(), np.asarray(jch))
        assert float(pm.reward) == float(jm.reward)
        assert int(pm.interactions) == int(jm.interactions)
    _assert_state_close(ps.state, js.state)
    if policy != "linucb":          # two refreshes fired: clusters moved
        assert float(getattr(ps.state, "core", ps.state).comm_bytes) > 0

    # the two halves: recommend (no state change) then observe
    u, c = batch(9, pad=True), contexts(9, policy)
    jch = jserve.recommend(js, jnp.asarray(u), jnp.asarray(c))
    pch = serve.recommend(ps, torch.from_numpy(u), torch.from_numpy(c))
    np.testing.assert_array_equal(pch.numpy(), np.asarray(jch))
    assert pch[5] == 0 and pch[9] == 0          # padding: choice 0
    r = uniforms(9) < 0.5
    js = jserve.observe(js, jnp.asarray(u), jnp.asarray(c), jch,
                        jnp.asarray(r.numpy(), jnp.float32))
    ps = serve.observe(ps, torch.from_numpy(u), torch.from_numpy(c), pch,
                       r.float())
    _assert_state_close(ps.state, js.state)

    # an all-padding batch is a no-op
    before = ps.state
    u = np.array([-1, N_USERS, -5, N_USERS + 1] * 3, np.int32)
    ps, pch, pm = serve.step(ps, 0, torch.from_numpy(u),
                             torch.from_numpy(c), preward)
    assert int(pm.interactions) == 0 and not pch.any()
    _assert_states_equal(before, ps.state)


def test_dccb_refresh_draws_peers_with_the_session_seed():
    """The gossip peers are keyed by the session's seed and its lifetime
    interaction count: 3 batches of 12 spend the 36-interaction budget."""
    from repro_torch.core import env_ops
    seen = []

    def spy(seed, step, adj):
        seen.append((seed, step))
        return env_ops.draw_peers(seed, step, adj)

    for seed in (0, 5):
        s = serve.OnlineBandit.create(N_USERS, D, PHYPER, policy="dccb",
                                      refresh_every=REFRESH, seed=seed,
                                      device="cpu")
        s = dataclasses.replace(s, policy=s.policy._replace(peers_fn=spy))
        for i in range(3):
            s, _, _ = serve.step(s, i, torch.from_numpy(batch(i)),
                                 torch.from_numpy(contexts(i, "dccb")),
                                 preward)
    assert seen == [(0, 3 * B), (5, 3 * B)]
    adj = torch.ones(N_USERS, N_USERS, dtype=torch.bool)
    assert not torch.equal(env_ops.draw_peers(0, 3 * B, adj),
                           env_ops.draw_peers(5, 3 * B, adj))


@pytest.mark.parametrize("policy", ["distclub", "club", "linucb", "dccb"])
def test_catalog_step_matches_reference_pruned_and_unpruned(policy):
    jc, pc = _catalogs(policy)
    pcl = serve.build_clusters(pc, tile_items=TILE)
    js, ps = _sessions(policy)
    pp = ps
    for i in range(6):
        u = batch(i, pad=i == 2)
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
        if i == 2:
            assert pit[5] == -1 and pit[9] == -1
    _assert_state_close(ps.state, js.state)
    _assert_states_equal(ps.state, pp.state)


def test_catalog_skip_counts_match_reference():
    """The pruned plain path skips exactly the tiles the reference skips
    for the same bounds, and serves the same items: users that know their
    taste (w = theta, 20 interactions) against tight item regions."""
    noise = np.random.default_rng(8).normal(size=(N_ITEMS, D))
    tight = _unit(_CENT[np.arange(N_ITEMS) % 4] + 0.02 * noise)
    jc = jserve.make_catalog(jnp.asarray(tight))
    pc = convert.record_from_numpy(jc, serve.Catalog, device="cpu")
    jcl = jserve.build_clusters(jc, tile_items=TILE, kind="reference")
    pcl = serve.build_clusters(pc, tile_items=TILE)
    np.testing.assert_array_equal(pcl.perm.numpy(), np.asarray(jcl.perm))
    js, ps = _sessions("linucb")
    warm = js.state._replace(
        Minv=jnp.broadcast_to(jnp.eye(D) / 20.0, (N_USERS, D, D)),
        b=20.0 * JTHETA, occ=jnp.full((N_USERS,), 20, jnp.int32))
    js = dataclasses.replace(js, state=warm)
    ps = dataclasses.replace(ps, state=convert.record_from_numpy(
        warm, serve.LinUCBServeState, device="cpu"))
    skipped = []
    for i in range(4):
        u = batch(i)
        js, jit, _, jrm = jserve.step_catalog(
            js, jax.random.PRNGKey(i), jnp.asarray(u), jc, jreward,
            k_short=K_SHORT, clusters=jcl)
        ps, pit, _, prm = serve.step_catalog(ps, i, torch.from_numpy(u), pc,
                                             preward, k_short=K_SHORT,
                                             clusters=pcl)
        np.testing.assert_array_equal(pit.numpy(), np.asarray(jit))
        assert (prm.tiles_skipped, prm.tiles_total) == (
            int(jrm.tiles_skipped), int(jrm.tiles_total))
        skipped.append(prm.tiles_skipped)
    assert sum(skipped) > 0


def test_recommend_catalog_observe_equals_step_catalog():
    _, pc = _catalogs()
    _, a = _sessions("distclub")
    b = a
    for i in range(4):
        u = torch.from_numpy(batch(i))
        a, ia, _ = serve.step_catalog(a, i, u, pc, preward, k_short=K_SHORT)
        ib, slots, ctx = serve.recommend_catalog(b, u, pc, k_short=K_SHORT)
        assert torch.equal(ia, ib)
        realized, _, _, _ = preward(i, u, ctx, slots)
        b = serve.observe(b, u, ctx, slots, realized)
    for x, y in zip(a.state, b.state):
        assert torch.equal(x, y)


def test_from_offline_serves_like_reference():
    """An offline reference run, handed across, warm-starts both packages'
    sessions identically."""
    cfg = jbackend.BackendConfig.create("reference")
    jhyper = JHyper(sigma=4, max_rounds=6, gamma=0.6, n_candidates=K)
    e, _ = jenv.make_synthetic_env(jax.random.PRNGKey(0), N_USERS, D, 3, K,
                                   within_cluster_noise=0.05)
    jstate, _, _ = jdistclub.run(
        jenv_ops.synthetic_ops(e), jax.random.PRNGKey(1), jhyper,
        n_epochs=1, d=D, backend=cfg.interact(N_USERS, D, K),
        graph=cfg.graph(N_USERS))
    pstate = convert.state_from_numpy(jax.tree.map(np.asarray, jstate),
                                      device="cpu")
    hyper = dict(HYPER, gamma=0.6)
    js = jserve.OnlineBandit.from_offline(jstate, JHyper(**hyper),
                                          refresh_every=REFRESH,
                                          backend="reference")
    ps = serve.OnlineBandit.from_offline(pstate, BanditHyper(**hyper),
                                         refresh_every=REFRESH)
    _assert_state_close(ps.state, js.state)
    jc, pc = _catalogs()
    for i in range(4):
        u = batch(i)
        js, jit, _ = jserve.step_catalog(js, jax.random.PRNGKey(i),
                                         jnp.asarray(u), jc, jreward,
                                         k_short=K_SHORT)
        ps, pit, _ = serve.step_catalog(ps, i, torch.from_numpy(u), pc,
                                        preward, k_short=K_SHORT)
        np.testing.assert_array_equal(pit.numpy(), np.asarray(jit))
    _assert_state_close(ps.state, js.state)
    back = serve.to_distclub_state(ps.state, BanditHyper(**hyper), D)
    np.testing.assert_array_equal(back.graph.labels.numpy(),
                                  ps.state.labels.numpy())


def test_stale_clusters_fall_back_to_unpruned():
    _, pc = _catalogs()
    cl = serve.build_clusters(pc, tile_items=TILE)
    _, a = _sessions("distclub")
    b = a
    u = torch.arange(B, dtype=torch.int32)
    a, ia, _ = serve.step_catalog(a, 0, u, pc, preward, k_short=K_SHORT)
    b, ib, _, rm = serve.step_catalog(b, 0, u, pc, preward, k_short=K_SHORT,
                                      clusters=cl)
    assert torch.equal(ia, ib) and rm.pruned_active == 1
    # a mass retirement the table has not seen
    pc, _ = serve.retire_items(pc, torch.arange(0, N_ITEMS, 2))
    pc = serve.publish(pc)
    a, ia, _ = serve.step_catalog(a, 1, u, pc, preward, k_short=K_SHORT)
    b, ib, _, rm = serve.step_catalog(b, 1, u, pc, preward, k_short=K_SHORT,
                                      clusters=cl)
    assert torch.equal(ia, ib)
    assert (rm.pruned_active, rm.tiles_total) == (0, 0)
    assert bool((ia % 2 == 1).all())                 # retired never served
    cl = serve.refresh_clusters(cl, pc)
    a, ia, _ = serve.step_catalog(a, 2, u, pc, preward, k_short=K_SHORT)
    b, ib, _, rm = serve.step_catalog(b, 2, u, pc, preward, k_short=K_SHORT,
                                      clusters=cl)
    assert torch.equal(ia, ib) and rm.pruned_active == 1


def test_delayed_feedback_under_churn_matches_reference():
    """Decisions issued over several epochs, delivered late, shuffled,
    re-delivered and with padding, while the catalog churns: the port's
    counters equal the reference's after every delivery, the conservation
    identity holds, and the folded statistics agree."""
    kw = dict(pending_capacity=48, pending_ttl=1)
    js, ps = _sessions("distclub", **kw)
    jc, pc = _catalogs()
    backlog = []
    for i in range(5):
        u = batch(i, pad=i == 1)
        js, jit, jids, jslots, jctx = jserve.recommend_catalog(
            js, jnp.asarray(u), jc, k_short=K_SHORT)
        ps, pit, pids, pslots, pctx = serve.recommend_catalog(
            ps, torch.from_numpy(u), pc, k_short=K_SHORT)
        np.testing.assert_array_equal(pit.numpy(), np.asarray(jit))
        np.testing.assert_array_equal(pids.numpy(), np.asarray(jids))
        realized, _, _, _ = jreward(jax.random.PRNGKey(i), jnp.asarray(u),
                                    jctx, jslots)
        backlog += list(zip(np.asarray(jids).tolist(),
                            np.asarray(realized).tolist()))
        if i in (1, 3):              # churn: retire what was just served
            gone = np.unique(np.asarray(jit)[np.asarray(jit) >= 0])[:3]
            jc, _ = jserve.retire_items(jc, jnp.asarray(gone))
            pc, _ = serve.retire_items(pc, torch.from_numpy(gone))
            jc, pc = jserve.publish(jc), serve.publish(pc)
        # deliver a shuffled slice of the backlog, with a re-delivery
        rng = np.random.default_rng(i)
        take = [backlog.pop(j) for j in sorted(
            rng.choice(len(backlog), min(len(backlog), 9), replace=False),
            reverse=True)]
        ids = np.full(B, -1, np.int32)
        rs = np.zeros(B, np.float32)
        ids[:len(take)] = [t[0] for t in take]
        rs[:len(take)] = [t[1] for t in take]
        ids[-1], rs[-1] = ids[0], rs[0]
        js = jserve.observe_delayed(js, jnp.asarray(ids), jnp.asarray(rs),
                                    catalog=jc)
        ps = serve.observe_delayed(ps, torch.from_numpy(ids),
                                   torch.from_numpy(rs), catalog=pc)
        assert serve.pending_stats(ps) == jserve.pending_stats(js)
        assert pending.conservation_gap(ps.pending) == 0
    st = serve.pending_stats(ps)
    assert st["stale"] > 0 and st["expired"] > 0 and st["unmatched"] > 0
    _assert_state_close(ps.state, js.state)
    ps = serve.reset_pending(ps)
    assert serve.pending_stats(ps)["in_flight"] == 0
    assert int(ps.pending.next_id) == 5 * B


def test_pending_buffer_rejects_wide_batches_and_sync_sessions():
    _, ps = _sessions("linucb", pending_capacity=8)
    with pytest.raises(ValueError, match="pending capacity"):
        serve.recommend(ps, torch.from_numpy(batch(0)),
                        torch.from_numpy(contexts(0)))
    _, sync = _sessions("linucb")
    with pytest.raises(ValueError, match="buffer-enabled"):
        serve.observe_delayed(sync, torch.zeros(2, dtype=torch.int32),
                              torch.zeros(2))
