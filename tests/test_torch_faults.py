"""The port's fault harness (``repro_torch.serve.faults``) and delayed
feedback against ``repro.serve.faults`` on the CPU, at
``tests/test_faults.py``'s sizes: both packages serve the same traffic,
``repro``'s users, contexts, Bernoulli draws and churn items replayed to
the port through a ``faults.Tape``; the fault draws (NumPy
``default_rng(spec.seed)``) are each package's own and must agree draw
for draw.  Choices, counters, events, publishes and items added and
retired are equal; float totals of the expected rewards agree to 1e-5
(relative), the realized reward exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import serve as jserve  # noqa: E402
from repro.core import env as jenv  # noqa: E402
from repro.core.types import BanditHyper as JHyper  # noqa: E402
from repro.serve import faults as jfaults  # noqa: E402
from repro_torch import convert, serve  # noqa: E402
from repro_torch.core import env  # noqa: E402
from repro_torch.core.types import BanditHyper  # noqa: E402
from repro_torch.serve import faults, pending  # noqa: E402

N, D, K, B = 32, 8, 10, 16
HYPER = dict(sigma=4, max_rounds=1, gamma=1.5, n_candidates=K)
JHYPER, PHYPER = JHyper(**HYPER), BanditHyper(**HYPER)
POLICIES = ("distclub", "club", "linucb", "dccb")


def jsession(policy="linucb", capacity=64, ttl=8, refresh_every=N):
    return jserve.OnlineBandit.create(
        N, D, JHYPER, policy=policy, refresh_every=refresh_every,
        pending_capacity=capacity, pending_ttl=ttl, backend="reference")


def psession(policy="linucb", capacity=64, ttl=8, refresh_every=N):
    return serve.OnlineBandit.create(
        N, D, PHYPER, policy=policy, refresh_every=refresh_every,
        pending_capacity=capacity, pending_ttl=ttl, device="cpu")


@pytest.fixture(scope="module")
def world():
    """``repro``'s planted world and its theta as a tensor."""
    e, _ = jenv.make_synthetic_env(jax.random.PRNGKey(0), N, D, 4, K)
    return e, torch.from_numpy(np.array(e.theta))


def uids(i, n=B):
    return torch.from_numpy(np.array(
        jax.random.randint(jax.random.PRNGKey(1000 + i), (n,), 0, N)))


def ctx(i, n=B):
    c = jax.random.normal(jax.random.PRNGKey(2000 + i), (n, K, D))
    return torch.from_numpy(np.array(c / jnp.sqrt(jnp.float32(D))))


def draws(key, n=B):
    """The Bernoulli uniforms of ``repro``'s ``step_rewards`` at ``key``."""
    return torch.from_numpy(np.array(jax.random.uniform(key, (n,))))


def rewards(theta, i, u, c, choice):
    return env.step_rewards(draws(jax.random.PRNGKey(i), u.shape[0]),
                            theta[u.long()], c, choice)


def tape(key, rounds, batch, *, slates=True, churn=None):
    """``repro``'s ``TrafficStream(key)`` for ``rounds`` rounds as a
    ``faults.Tape``; ``churn`` maps a churn step to ``(env, seed, m,
    region)`` for ``repro``'s ``sample_churn_items`` draw at it."""
    s = jfaults.TrafficStream(key, batch, N, K=K, d=D)
    users, contexts, uniforms = [], [], []
    for i in range(rounds):
        if slates:
            u, c, kr, _ = s.slate_batch(i)
            contexts.append(np.asarray(c))
        else:
            u, kr, _ = s.catalog_batch(i)
        users.append(np.asarray(u))
        uniforms.append(np.asarray(jax.random.uniform(kr, (batch,))))
    items = {}
    for step, (e, seed, m, region) in (churn or {}).items():
        k = jax.random.fold_in(jax.random.PRNGKey(seed + 0x5EED), step)
        items[step] = torch.from_numpy(np.array(
            jenv.sample_churn_items(e, k, m, region=region)[0]))
    return faults.Tape(
        users=torch.from_numpy(np.stack(users)),
        uniforms=torch.from_numpy(np.stack(uniforms)),
        contexts=torch.from_numpy(np.stack(contexts)) if slates else None,
        churn=items)


def assert_reports_equal(p, j):
    for f in ("rounds", "interactions", "delivered", "pending", "events",
              "publishes", "items_added", "items_retired", "reward"):
        assert getattr(p, f) == getattr(j, f), f
    for f in ("expected", "best", "rand_reward", "regret"):
        np.testing.assert_allclose(getattr(p, f), getattr(j, f), rtol=1e-5,
                                   err_msg=f)


def assert_states_equal(a, b):
    for x, y in zip(a, b):
        if hasattr(x, "_fields"):
            assert_states_equal(x, y)
        else:
            assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                    else x == y)


def assert_close_to_reference(p, j):
    got = convert.record_to_numpy(p)
    for f in got._fields:
        a, b = getattr(got, f), np.asarray(getattr(j, f))
        if f in ("Minv", "b", "uMcinv", "ubc", "umean_occ", "comm_bytes"):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


# ---------------------------------------------------------------------------
# delay-0 parity with the synchronous transaction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", POLICIES)
def test_delay0_split_is_bit_identical_to_step(world, policy):
    """recommend -> observe_delayed with immediate delivery lands on the
    bytes of the fused ``step``, for each ported policy; the split run's
    choices are ``repro``'s (dccb: the port's gossip peers are its own)."""
    _, theta = world
    sync = psession(policy, capacity=0)
    split = psession(policy)
    ref = jsession(policy)
    for i in range(6):
        u, c = uids(i), ctx(i)
        sync, ch_a, _ = serve.step(sync, i, u, c,
                                   lambda k, u, c, ch: rewards(theta, k, u,
                                                               c, ch))
        split, ch_b, ids = serve.recommend(split, u, c)
        assert torch.equal(ch_a, ch_b)
        realized = rewards(theta, i, u, c, ch_b)[0]
        split = serve.observe_delayed(split, ids, realized)
        if policy != "dccb":
            ref, jch, jids = jserve.recommend(ref, jnp.asarray(u.numpy()),
                                              jnp.asarray(c.numpy()))
            np.testing.assert_array_equal(ch_b.numpy(), np.asarray(jch))
            np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
            ref = jserve.observe_delayed(ref, jids,
                                         jnp.asarray(realized.numpy()),
                                         key=jax.random.PRNGKey(i))
    assert_states_equal(sync.state, split.state)
    st = serve.pending_stats(split)
    assert st["in_flight"] == 0
    assert st["matched"] == 6 * B and st["unmatched"] == 0
    if policy != "dccb":
        assert st == jserve.pending_stats(ref)
        assert_close_to_reference(split.state, ref.state)


def test_catalog_issue_delay0_parity():
    """recommend_catalog on a buffer session + observe_delayed ==
    step_catalog, bit for bit, on ``repro``'s catalog env."""
    e, _ = jenv.make_catalog_env(jax.random.PRNGKey(3), N, D, 4, 64,
                                 n_candidates=K)
    cat = convert.catalog_from_numpy(jax.tree.map(
        np.asarray, jserve.make_catalog(jenv.catalog_embeddings(e))),
        device="cpu")
    theta = torch.from_numpy(np.array(e.theta))
    sync = psession("distclub", capacity=0)
    split = psession("distclub")
    for i in range(4):
        u = uids(i)
        sync, it_a, _ = serve.step_catalog(
            sync, i, u, cat, lambda k, u, c, ch: rewards(theta, k, u, c, ch),
            k_short=8)
        split, it_b, ids, slots, c = serve.recommend_catalog(split, u, cat,
                                                             k_short=8)
        assert torch.equal(it_a, it_b)
        split = serve.observe_delayed(split, ids,
                                      rewards(theta, i, u, c, slots)[0])
    assert_states_equal(sync.state, split.state)


# ---------------------------------------------------------------------------
# exactness under hostile delivery
# ---------------------------------------------------------------------------


def test_out_of_order_duplicate_padded_delivery_exact(world):
    """Shuffled cross-round delivery, re-delivery, an in-batch duplicate
    and id -1 padding fold every decision exactly once."""
    _, theta = world
    sess = psession(ttl=16)
    backlog, round0 = [], None
    for i in range(4):
        sess, ch, ids = serve.recommend(sess, uids(i), ctx(i))
        realized = rewards(theta, i, uids(i), ctx(i), ch)[0]
        entries = list(zip(ids.tolist(), realized.tolist()))
        backlog += entries
        round0 = entries if i == 0 else round0
    inorder = tangled = sess
    for c in range(4):
        part = backlog[c * B:(c + 1) * B]
        inorder = serve.observe_delayed(
            inorder, torch.tensor([e[0] for e in part], dtype=torch.int32),
            torch.tensor([e[1] for e in part]))
    rng = np.random.default_rng(0)
    fb = [backlog[j] for j in rng.permutation(len(backlog))]
    for c, lo in enumerate(range(0, len(fb), B - 1)):
        chunk = fb[lo:lo + B - 1]
        ids = np.full((B,), -1, np.int32)
        rs = np.zeros((B,), np.float32)
        ids[:len(chunk)] = [e[0] for e in chunk]
        rs[:len(chunk)] = [e[1] for e in chunk]
        if c == 0:
            ids[B - 1], rs[B - 1] = ids[0], rs[0]
        tangled = serve.observe_delayed(tangled, torch.from_numpy(ids),
                                        torch.from_numpy(rs))
    before = tangled.state
    tangled = serve.observe_delayed(
        tangled, torch.tensor([e[0] for e in round0], dtype=torch.int32),
        torch.tensor([e[1] for e in round0]))
    assert_states_equal(before, tangled.state)
    st = serve.pending_stats(tangled)
    assert st["matched"] == 4 * B and st["unmatched"] == 1 + B, st
    assert torch.equal(tangled.state.occ, inorder.state.occ)
    assert int(tangled.state.occ.sum()) == 4 * B
    for f in ("b", "Minv"):
        torch.testing.assert_close(getattr(tangled.state, f),
                                   getattr(inorder.state, f), rtol=0,
                                   atol=1e-5)


def test_ttl_expiry_counts_and_drops():
    sess = psession(ttl=2)
    sess, _, ids0 = serve.recommend(sess, uids(0), ctx(0))
    for i in (1, 2):
        sess, _, _ = serve.recommend(sess, uids(i), ctx(i))
    assert serve.pending_stats(sess)["expired"] == 0
    sess, _, _ = serve.recommend(sess, uids(3), ctx(3))
    assert serve.pending_stats(sess)["expired"] == B
    before = sess.state
    sess = serve.observe_delayed(sess, ids0, torch.ones(B))
    st = serve.pending_stats(sess)
    assert st["unmatched"] == B and st["matched"] == 0
    assert_states_equal(before, sess.state)


def test_capacity_backpressure_evicts_and_counts():
    sess = psession(capacity=B, ttl=100)
    sess, _, ids0 = serve.recommend(sess, uids(0), ctx(0))
    sess, _, ids1 = serve.recommend(sess, uids(1), ctx(1))
    st = serve.pending_stats(sess)
    assert st["dropped"] == B and st["in_flight"] == B, st
    sess = serve.observe_delayed(sess, ids0, torch.ones(B))
    st = serve.pending_stats(sess)
    assert st["unmatched"] == B and st["matched"] == 0
    sess = serve.observe_delayed(sess, ids1, torch.ones(B))
    assert serve.pending_stats(sess)["matched"] == B


def test_batch_wider_than_capacity_rejected():
    with pytest.raises(ValueError, match="capacity"):
        serve.recommend(psession(capacity=8), uids(0), ctx(0))


# ---------------------------------------------------------------------------
# the seeded fault suite against repro on the same tape
# ---------------------------------------------------------------------------


def test_seeded_fault_suite_report_matches_reference(world):
    """30% delayed, 10% lost, 5% duplicated: the port's FaultReport is
    ``repro``'s on the same traffic, and degrades boundedly against its
    clean control."""
    e, theta = world
    spec = faults.FaultSpec(seed=7, p_delay=0.3, max_delay=4, p_loss=0.1,
                            p_dup=0.05)
    stream = faults.TrafficStream(11, B, N, device="cpu",
                                  tape=tape(11, 30, B))
    _, clean = faults.run_faulted(psession(capacity=256, ttl=16), theta, 30,
                                  faults.FaultSpec(), batch=B,
                                  stream=stream)
    sess, rep = faults.run_faulted(psession(capacity=256, ttl=16), theta,
                                   30, spec, batch=B, stream=stream)
    jsess, jrep = jfaults.run_faulted(jsession(capacity=256, ttl=16),
                                      e.theta, 30, spec, batch=B, key=11)
    assert_reports_equal(rep, jrep)
    assert_close_to_reference(sess.state, jsess.state)
    assert rep.interactions == clean.interactions == 30 * B
    assert rep.reward >= 0.8 * clean.reward
    assert rep.regret <= 1.5 * clean.regret + 5.0
    st = rep.pending
    lost = st["issued"] - st["matched"]
    assert 0 < lost < 0.2 * st["issued"], st
    assert st["in_flight"] + st["expired"] + st["dropped"] == lost, st
    assert st["unmatched"] > 0, st


def test_stall_backlog_floods_then_drains(world):
    e, theta = world
    spec = faults.FaultSpec(seed=3, stall_every=5, stall_rounds=2)
    _, rep = faults.run_faulted(
        psession(capacity=256, ttl=16), theta, 20, spec, batch=B,
        stream=faults.TrafficStream(5, B, N, device="cpu",
                                    tape=tape(5, 20, B)))
    _, jrep = jfaults.run_faulted(jsession(capacity=256, ttl=16), e.theta,
                                  20, spec, batch=B, key=5)
    assert_reports_equal(rep, jrep)
    st = rep.pending
    assert st["matched"] == st["issued"] == 20 * B, st
    assert st["unmatched"] == 0 and st["expired"] == 0, st


CHURN = faults.FaultSpec(
    seed=4, p_delay=0.3, max_delay=3, p_loss=0.05, p_dup=0.05,
    churn_every=3, churn_add=12, churn_retire=10, swap_stall_rounds=1,
    p_torn=0.5, flash_crowd_at=4, flash_crowd_size=16, mass_retire_at=7)


def test_churn_faults_match_reference_with_conservation():
    """Every churn fault at once (sustained churn, swap stalls, torn
    publishes, a flash crowd, a mass retirement) on a buffer session
    with the quarantine live: conservation holds after every delivery,
    and stale, publishes, items added and retired and every counter are
    ``repro``'s."""
    rounds, n_items = 14, 96
    je, _ = jenv.make_catalog_env(jax.random.PRNGKey(1), N, D, 4, n_items,
                                  n_candidates=K)
    jcat = jserve.make_catalog(jenv.catalog_embeddings(je), capacity=160)
    pe = convert.record_from_numpy(jax.tree.map(np.asarray, je),
                                   env.CatalogEnv, device="cpu")
    pcat = convert.catalog_from_numpy(jax.tree.map(np.asarray, jcat),
                                      device="cpu")
    hot = int(np.bincount(np.asarray(je.item_region), minlength=4).argmax())
    churn = {2 * CHURN.flash_crowd_at: (je, CHURN.seed,
                                        CHURN.flash_crowd_size, hot)}
    for i in range(rounds):
        if (i + 1) % CHURN.churn_every == 0:
            churn[2 * i + 1] = (je, CHURN.seed, CHURN.churn_add, None)
    stream = faults.TrafficStream(9, B, N, device="cpu",
                                  tape=tape(9, rounds, B, slates=False,
                                            churn=churn))
    sess, rep = faults.run_faulted_catalog(
        psession("distclub", capacity=128, ttl=4), pe, rounds, CHURN,
        catalog=pcat, k_short=8, batch=B, stream=stream,
        assert_conservation=True)
    jsess, jrep = jfaults.run_faulted_catalog(
        jsession("distclub", capacity=128, ttl=4), je, rounds, CHURN,
        catalog=jcat, k_short=8, batch=B, key=9, assert_conservation=True)
    assert_reports_equal(rep, jrep)
    assert rep.pending["stale"] > 0 and rep.publishes >= 4
    assert rep.items_retired > CHURN.churn_retire
    assert pending.conservation_gap(sess.pending) == 0
    assert_close_to_reference(sess.state, jsess.state)


# ---------------------------------------------------------------------------
# the port's own traffic stream
# ---------------------------------------------------------------------------


def test_traffic_stream_is_keyed_and_clean_control_repeats(world):
    _, theta = world
    a = faults.TrafficStream(3, B, N, K=K, d=D, device="cpu")
    b = faults.TrafficStream(3, B, N, K=K, d=D, device="cpu")
    for i in range(3):
        for x, y in zip(a.slate_batch(i), b.slate_batch(i)):
            assert torch.equal(x, y)
        for x, y in zip(a.catalog_batch(i), b.catalog_batch(i)):
            assert torch.equal(x, y)
    u, c, r = a.slate_batch(0)
    assert u.dtype == torch.int32 and int(u.min()) >= 0 and int(u.max()) < N
    assert c.shape == (B, K, D) and r.shape == (B,)
    assert 0.0 <= float(r.min()) and float(r.max()) < 1.0
    assert not torch.equal(c, a.slate_batch(1)[1])
    assert not torch.equal(u, faults.TrafficStream(
        4, B, N, K=K, d=D, device="cpu").slate_batch(0)[0])
    # the same key drives the same run, run to run
    sess, rep = faults.run_faulted(psession(), theta, 6, faults.FaultSpec(),
                                   batch=B, key=3)
    sess2, rep2 = faults.run_faulted(psession(), theta, 6,
                                     faults.FaultSpec(), batch=B, key=3)
    assert rep.reward == rep2.reward and rep.interactions == 6 * B
    assert_states_equal(sess.state, sess2.state)
    # churn items: unit rows in the env's regions, keyed by (seed, step)
    pe, _ = env.make_catalog_env(1, N, D, 4, 64, device="cpu")
    x = a.churn_items(pe, 5, 3, 8)
    assert x.shape == (8, D) and torch.equal(x, b.churn_items(pe, 5, 3, 8))
    assert not torch.equal(x, a.churn_items(pe, 5, 4, 8))
    torch.testing.assert_close(torch.linalg.norm(x, dim=1), torch.ones(8))


# ---------------------------------------------------------------------------
# the CLI, at a tiny size on the CPU
# ---------------------------------------------------------------------------

TINY = ["--device", "cpu", "--users", "32", "--d", "8", "--batch", "8",
        "--capacity", "64", "--rounds", "12"]


@pytest.mark.parametrize("extra", [
    ["--guard", "--flip", "1.0", "--flip-after", "4", "--ctr-floor", "0.4",
     "--delay", "0.3", "--loss", "0.1", "--dup", "0.05"],
    ["--scenario", "churn", "--guard", "--items", "64", "--item-capacity",
     "96", "--k-short", "8", "--churn-add", "8", "--churn-retire", "8",
     "--torn", "0.5", "--swap-stall", "1", "--flash-crowd-at", "3",
     "--flash-crowd-size", "8", "--mass-retire-at", "6",
     "--churn-ceiling", "0.3"]])
def test_faultrun_cli_prints_the_reference_report(extra, capsys):
    from repro_torch.launch import faultrun
    clean, rep = faultrun.main(TINY + extra)
    out = capsys.readouterr().out
    for label in ("rounds x 8", "clean  : reward", "faulted: reward",
                  "regret degradation:", "pending: {", "guard event:"):
        assert label in out, (label, out)
    assert rep.interactions == clean.interactions == 12 * 8
    if "churn" in extra:
        assert "churn: " in out and "feedback quarantined" in out
        assert rep.publishes >= 3 and rep.items_added > 0
    else:
        assert any(ev[0] == "rollback" for ev in rep.events)
