"""The port's environment kinds (``repro_torch.core.env`` /
``env_ops``: drift, catalog and replay) against ``repro``'s on the CPU:
the reference's tables carried across with ``convert.record_from_numpy``
and the reference's own draws replayed through ``env_ops.tape_draws``;
each kind's contracts; DistCLUB end to end on each kind, and CLUB and
DCCB on one kind each, against ``repro`` on a tape of its key schedule.

Catalog contexts are computed by each package from the same slate ids
(``region_centroids[phase, region[ids]] + item_noise[ids]``, normalised),
so they are held within 2 ulp of the reference's, not bit for bit; every
other context is a gather or a tape and is bit-equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import backend as jbackend  # noqa: E402
from repro.core import club as jclub  # noqa: E402
from repro.core import dccb as jdccb  # noqa: E402
from repro.core import distclub as jdistclub  # noqa: E402
from repro.core import env as jenv  # noqa: E402
from repro.core import env_ops as jenv_ops  # noqa: E402
from repro.core.types import BanditHyper as JHyper  # noqa: E402
from repro.data import datasets as jdatasets  # noqa: E402
from repro.data import replay as jreplay  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import club, dccb, distclub, env, env_ops  # noqa: E402
from repro_torch.core.types import BanditHyper  # noqa: E402
from repro_torch.data import replay  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

N, D, K, N_CLUSTERS = 37, 5, 10, 3
N_ITEMS = 48                 # catalog items: slates repeat items
REPLAY_ITEMS, MAX_T = 24, 6  # a slate of 10 of 23 ids nearly always
                             # holds a duplicate; cursors pass max_t
DRIFT_PERIOD = 3
CATALOG_PERIOD, CATALOG_PHASES = 5, 2
N_EPOCHS = 2
HYPER = dict(sigma=4, max_rounds=8, gamma=0.6)


def _np(record):
    return jax.tree.map(np.asarray, record)


def _reference(kind):
    """(reference EnvOps, the port's tables of the same environment): the
    drift and catalog records carried across with ``record_from_numpy``,
    replay's three tables as a ``ReplayLog``."""
    key = jax.random.PRNGKey(0)
    if kind == "drift":
        je, _ = jenv.make_drift_env(key, N, D, N_CLUSTERS, K,
                                    drift_period=DRIFT_PERIOD, n_phases=4)
        e = convert.record_from_numpy(_np(je), env.DriftEnv, device="cpu")
        return jenv_ops.drift_ops(je), e
    if kind == "catalog":
        je, _ = jenv.make_catalog_env(key, N, D, N_CLUSTERS, N_ITEMS,
                                      n_candidates=K,
                                      drift_period=CATALOG_PERIOD,
                                      n_phases=CATALOG_PHASES)
        e = convert.record_from_numpy(_np(je), env.CatalogEnv, device="cpu")
        return jenv_ops.catalog_ops(je), e
    spec = jdatasets.DatasetSpec("tiny", 64 * N, N, D, N_CLUSTERS, K)
    jops, _ = jreplay.make_replay_env(spec, n_items=REPLAY_ITEMS,
                                      max_t=MAX_T, seed=0)
    # make_replay_env's construction, by its key schedule (replay.py:32-46)
    k_env, k_items, k_cands = jax.random.split(jax.random.PRNGKey(0), 3)
    je, _ = jenv.make_synthetic_env(k_env, N, D, N_CLUSTERS, K,
                                    within_cluster_noise=0.05)
    feats = jax.random.normal(k_items, (REPLAY_ITEMS, D))
    feats = feats / jnp.linalg.norm(feats, axis=-1, keepdims=True)
    ids = jax.random.randint(k_cands, (N, MAX_T, K), 1, REPLAY_ITEMS)
    probs = jenv.expected_reward(je.theta[:, None, None, :], feats[ids])
    log = convert.record_from_numpy(
        replay.ReplayLog(*_np((feats, ids, probs))), replay.ReplayLog,
        device="cpu")
    return jops, log


def _port_ops(kind, tables, draws=env_ops.HASH_DRAWS):
    if kind == "drift":
        return env_ops.drift_ops(tables, draws)
    if kind == "catalog":
        return env_ops.catalog_ops(tables, draws)
    return env_ops.replay_ops(*tables, draws=draws)


def _draws(kind, n, k_ctx, k_rew):
    """The reference's draws of one round from its two keys: the unit
    contexts (drift), the slate ids (catalog: ``catalog_ops._slate``'s
    per-user ``randint``) or nothing (replay), and the Bernoulli uniforms
    (``_bernoulli_metrics``)."""
    keys = jenv_ops._user_keys(k_rew, n, 0)
    u = jax.vmap(lambda kk: jax.random.uniform(kk, ()))(keys)
    if kind == "drift":
        x = jenv_ops._unit_contexts(k_ctx, n, K, D, 0)
    elif kind == "catalog":
        x = jax.vmap(lambda kk: jax.random.randint(kk, (K,), 0, N_ITEMS))(
            jenv_ops._user_keys(k_ctx, n, 0))
    else:
        x = jnp.zeros((n, 0))
    return x, u


def _record(kind, round_keys):
    """The reference's draws ``(x [S, ...], uniforms [S, n])`` at each of
    ``round_keys`` (``(k_ctx, k_rew)`` pairs, in step order)."""
    fn = jax.jit(lambda kc, kr: _draws(kind, N, kc, kr))
    xs, us = zip(*(fn(kc, kr) for kc, kr in round_keys))
    return (torch.from_numpy(np.stack([np.asarray(v) for v in xs])),
            torch.from_numpy(np.stack([np.asarray(v) for v in us])))


def _tape(kind, round_keys, users=None):
    """``env_ops.tape_draws`` of ``_record``'s draws."""
    x, u = _record(kind, round_keys)
    return env_ops.tape_draws(
        u, contexts=x if kind == "drift" else None,
        slates=x if kind == "catalog" else None, users=users)


def _within_ulps(got, want, ulps):
    got, want = np.asarray(got), np.asarray(want)
    gap = np.abs(got.astype(np.float64) - want)
    spacing = np.spacing(np.maximum(np.abs(got), np.abs(want)))
    assert np.all(gap <= ulps * spacing), float(np.max(gap / spacing))


KINDS = ("drift", "catalog", "replay")


@pytest.mark.parametrize("kind", KINDS)
def test_ops_match_reference_on_its_tables_and_draws(kind):
    jops, tables = _reference(kind)
    k_ctx, k_rew = jax.random.split(jax.random.PRNGKey(3))
    ops = _port_ops(kind, tables, _tape(kind, [(k_ctx, k_rew)]))
    occ = np.random.default_rng(1).integers(0, 4 * MAX_T, N).astype(np.int32)
    occ_t = torch.from_numpy(occ)
    want = np.array(jops.contexts_fn(k_ctx, jnp.asarray(occ)))
    got = ops.contexts_fn(0, 0, occ_t)
    assert got.shape == (N, K, D) and got.is_contiguous()
    if kind == "catalog":
        _within_ulps(got.numpy(), want, 2)
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    choice = np.random.default_rng(2).integers(0, K, N).astype(np.int32)
    # both packages reward the reference's contexts
    jr = jops.rewards_fn(k_rew, jnp.asarray(occ), jnp.asarray(want),
                         jnp.asarray(choice))
    r = ops.rewards_fn(0, 0, occ_t, torch.from_numpy(want),
                       torch.from_numpy(choice))
    np.testing.assert_array_equal(r[0].numpy(), np.asarray(jr[0]))
    for a, b in zip(r[1:], jr[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("kind", KINDS)
def test_row_slices_see_the_full_range(kind):
    """The shard-invariance contract: a ``row0`` slice draws and rewards
    exactly the rows of the full range, with the port's own draws."""
    _, tables = _reference(kind)
    ops = _port_ops(kind, tables)
    occ = torch.from_numpy(
        np.random.default_rng(4).integers(0, 20, N).astype(np.int32))
    choice = torch.from_numpy(
        np.random.default_rng(5).integers(0, K, N).astype(np.int32))
    full = ops.contexts_fn(7, 11, occ)
    r_full = ops.rewards_fn(7, 11, occ, full, choice)
    for row0, m in ((16, N - 16), (5, 1), (0, 9)):
        part = ops.contexts_fn(7, 11, occ[row0:row0 + m], row0=row0)
        assert torch.equal(part, full[row0:row0 + m])
        r_part = ops.rewards_fn(7, 11, occ[row0:row0 + m], part,
                                choice[row0:row0 + m], row0=row0)
        for a, b in zip(r_full, r_part):
            assert torch.equal(a[row0:row0 + m], b)


def test_drift_redraws_at_the_period_and_holds_within_a_phase():
    _, e = _reference("drift")
    occ = lambda v: torch.full((N,), v, dtype=torch.int32)  # noqa: E731
    th = [env.drift_theta(e, occ(v)) for v in range(5 * DRIFT_PERIOD)]
    for v in range(1, len(th)):
        same = v % DRIFT_PERIOD != 0 or v >= 4 * DRIFT_PERIOD
        assert torch.equal(th[v], th[v - 1]) == same, v
    # the phase is clamped at the last one; the one-user slice of CLUB
    assert torch.equal(env.drift_theta(e, occ(10**6)), th[-1])
    u = 7
    assert torch.equal(env.drift_theta(e, occ(DRIFT_PERIOD)[:1], row0=u),
                       th[DRIFT_PERIOD][u:u + 1])


def test_replay_cursor_clamps_and_ignores_the_seed():
    _, log = _reference("replay")
    ops = env_ops.replay_ops(*log)
    occ = lambda v: torch.full((N,), v, dtype=torch.int32)  # noqa: E731
    last = ops.contexts_fn(0, 0, occ(MAX_T - 1))
    assert torch.equal(ops.contexts_fn(5, 9, occ(MAX_T + 3)), last)
    assert not torch.equal(ops.contexts_fn(0, 0, occ(MAX_T - 2)), last)
    assert torch.equal(last, log.item_feats[log.cand_ids[:, -1].long()])
    choice = torch.zeros(N, dtype=torch.int32)
    a = ops.rewards_fn(0, 0, occ(MAX_T + 3), last, choice)
    b = ops.rewards_fn(1, 0, occ(MAX_T - 1), last, choice)
    for x, y in zip(a[1:], b[1:]):            # the clicks' probabilities
        assert torch.equal(x, y)
    assert not torch.equal(a[0], b[0])        # only the uniforms moved


def test_catalog_phase0_slate_is_catalog_rows():
    _, e = _reference("catalog")
    # a drifting catalog's phase is clamped at its last; a static one's 0
    far = torch.full((N,), CATALOG_PERIOD * 9, dtype=torch.int32)
    assert bool((env.catalog_phase(e, far) == CATALOG_PHASES - 1).all())
    assert not bool(env.catalog_phase(e._replace(drift_period=0), far).any())
    ops = env_ops.catalog_ops(e._replace(drift_period=0))
    occ = torch.arange(N, dtype=torch.int32) * 100
    ids = env_ops._slate_ids(3, 4, N, K, N_ITEMS, 0, "cpu")
    assert bool((ids >= 0).all() and (ids < N_ITEMS).all())
    bits = env_ops._hash(3, env_ops._STREAM_SLATES, 4,
                         env_ops._counters(0, N, K, "cpu"))
    assert torch.equal(ids, (env_ops._srl(bits, 32) * N_ITEMS) >> 32)
    _within_ulps(ops.contexts_fn(3, 4, occ).numpy(),
                 env.catalog_embeddings(e, 0)[ids].numpy(), 2)
    # ids spread over the catalog; another seed or step, another slate
    many = env_ops._slate_ids(3, 5, 4096, K, N_ITEMS, 0, "cpu")
    counts = torch.bincount(many.flatten(), minlength=N_ITEMS)
    assert int(counts.min()) > 0.8 * many.numel() / N_ITEMS
    assert not torch.equal(ids, env_ops._slate_ids(4, 4, N, K, N_ITEMS, 0,
                                                   "cpu"))


def _distclub_round_keys(key, n_epochs, R):
    """``distclub.run``'s key schedule (distclub.py:218, 229;
    stages.py:95, 112): ``(k_ctx, k_rew)`` of every round in step
    order."""
    out = []
    for ke in jax.random.split(key, n_epochs):
        for ks in jax.random.split(ke):
            for k in jax.random.split(ks, R):
                out.append(tuple(jax.random.split(k)))
    return out


def _assert_states_match(port, ref):
    p = convert.state_to_numpy(port)
    for got, want in ((p.graph.labels, ref.graph.labels),
                      (p.graph.adj, ref.graph.adj), (p.lin.occ, ref.lin.occ),
                      (p.u_rounds, ref.u_rounds), (p.c_rounds, ref.c_rounds),
                      (p.comm_bytes, ref.comm_bytes)):
        np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_allclose(p.lin.Minv, np.asarray(ref.lin.Minv),
                               atol=1e-5)
    np.testing.assert_allclose(p.lin.b, np.asarray(ref.lin.b), atol=1e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_distclub_run_matches_reference_on_tape(kind):
    jhyper = JHyper(n_candidates=K, **HYPER)
    jops, tables = _reference(kind)
    key = jax.random.PRNGKey(1)
    cfg = jbackend.BackendConfig.create("reference")
    js, jm, jc = jdistclub.run(jops, key, jhyper, N_EPOCHS, D,
                               backend=cfg.interact(N, D, K),
                               graph=cfg.graph(N))
    ops = _port_ops(kind, tables, _tape(kind, _distclub_round_keys(
        key, N_EPOCHS, jhyper.max_rounds)))
    _build.reset_launches()
    s, m, c = distclub.run(ops, 0, BanditHyper(*jhyper), N_EPOCHS, D,
                           device="cpu")
    assert not any(_build.LAUNCHES.values())
    np.testing.assert_array_equal(m.reward.numpy(), np.asarray(jm.reward))
    np.testing.assert_array_equal(m.interactions.numpy(),
                                  np.asarray(jm.interactions))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    _assert_states_match(s, js)
    occ = np.asarray(js.lin.occ)
    assert occ.max() >= (DRIFT_PERIOD if kind == "drift" else
                         CATALOG_PERIOD if kind == "catalog" else MAX_T)


def test_club_matches_reference_on_replay():
    """CLUB on the replay kind: the reference's per-step users and
    uniforms (club.py:74-75), contexts gathered by both packages from
    the same log; duplicate candidates tie and go to the first copy."""
    T = 120
    jhyper = JHyper(alpha=0.3, gamma=0.4, delta_net=30, n_candidates=K)
    jops, log = _reference("replay")
    key = jax.random.PRNGKey(2)
    steps = [jax.random.split(k, 3) for k in jax.random.split(key, T)]
    users = [int(jax.random.randint(ku, (), 0, N)) for ku, _, _ in steps]
    ops = env_ops.replay_ops(*log, draws=_tape(
        "replay", [(kc, kr) for _, kc, kr in steps], users=users))
    js, jm = jclub.run(jops, key, jhyper, T, D,
                       graph=jbackend.BackendConfig.create(
                           "reference").graph(N))
    s, m = club.run(ops, 0, BanditHyper(*jhyper), T, D, device="cpu")
    np.testing.assert_array_equal(m.reward.numpy(), np.asarray(jm.reward))
    np.testing.assert_allclose(m.regret.numpy(), np.asarray(jm.regret),
                               rtol=0, atol=1e-6)
    p = convert.club_state_to_numpy(s)
    np.testing.assert_array_equal(p.graph.labels, np.asarray(js.graph.labels))
    np.testing.assert_array_equal(p.graph.adj, np.asarray(js.graph.adj))
    np.testing.assert_array_equal(p.lin.occ, np.asarray(js.lin.occ))
    for got, want in ((p.lin.Minv, js.lin.Minv), (p.lin.b, js.lin.b),
                      (p.clusters.Mcinv, js.clusters.Mcinv)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    assert np.asarray(js.lin.occ).max() > MAX_T      # cursors clamped


def test_dccb_matches_reference_on_drift():
    """DCCB on the drift kind.  Its first L rounds score with w = 0,
    Minv = I, where unit contexts tie to the last ulp; as in
    ``test_torch_dccb``, both packages get contexts scaled per slot,
    ``(1 + k / (2 K)) ctx``, and the reference's choose runs as its
    Pallas kernel in interpret mode (ties to the first index)."""
    L, n_epochs = 3, 3
    jhyper = JHyper(alpha=0.3, gamma=0.5, n_candidates=K, buffer_size=L)
    base, e = _reference("drift")
    scale = 1.0 + jnp.arange(K, dtype=jnp.float32) / (2 * K)
    jops = base._replace(contexts_fn=lambda k, occ, row0=0: base.contexts_fn(
        k, occ, row0) * scale[None, :, None])
    key = jax.random.PRNGKey(5)
    be = jbackend.BackendConfig.create("pallas").interact(N, D, K,
                                                          interpret=True)
    js, jm, jc = jdccb.run(jops, key, jhyper, n_epochs, D, L, backend=be)
    # dccb.run's key schedule (dccb.py:215, 223; stages.py:95, 112)
    rounds, k_gos = [], []
    for ke in jax.random.split(key, n_epochs):
        k_int, kg = jax.random.split(ke)
        k_gos.append(kg)
        rounds += [tuple(jax.random.split(k))
                   for k in jax.random.split(k_int, L)]
    ctx, uni = _record("drift", rounds)
    ops = env_ops.drift_ops(e, env_ops.tape_draws(
        uni, contexts=ctx * torch.from_numpy(np.array(scale))[:, None]))

    def peers(seed, step, adj):
        logits = jnp.where(jnp.asarray(adj.numpy()), 0.0, -jnp.inf)
        return torch.from_numpy(np.asarray(jax.random.categorical(
            k_gos[step], logits, axis=-1)).copy())

    s, m, c = dccb.run(ops._replace(peers_fn=peers), 0, BanditHyper(*jhyper),
                       n_epochs, D, L, device="cpu")
    np.testing.assert_array_equal(m.reward.numpy(), np.asarray(jm.reward))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    got = convert.dccb_state_to_numpy(s)
    for f in ("occ", "adj"):
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(js, f)))
    for f in ("Mw", "bw", "Mbuf", "bbuf"):
        np.testing.assert_allclose(getattr(got, f),
                                   np.asarray(getattr(js, f)), rtol=0,
                                   atol=1e-5)
    assert float(s.comm_bytes) == float(js.comm_bytes) > 0
    assert np.asarray(js.occ).max() >= DRIFT_PERIOD
