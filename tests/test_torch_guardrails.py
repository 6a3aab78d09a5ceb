"""The port's guardrails (``repro_torch.serve.guardrails``) against
``repro.serve.guardrails`` on the CPU, at ``tests/test_faults.py``'s
sizes: the monitor arithmetic on the same samples (breaches, EMAs and
cooldown equal as Python floats), a guarded sign-flip run whose events
are ``repro``'s and whose rolled-back session resumes bit-identically, an
occupancy trip, a catalog-tracking rollback of the (state, catalog,
epoch) triple on a churn-ceiling breach, and ``shortlist_recall`` on the
unpruned and cluster-pruned paths.  Latency is not compared: the
latency monitor stays disarmed, as in ``repro``'s tests."""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import serve as jserve  # noqa: E402
from repro.core import env as jenv  # noqa: E402
from repro.serve import faults as jfaults  # noqa: E402
from repro.serve import guardrails as jguard  # noqa: E402
from repro.train.checkpoint import CheckpointManager as JCkpt  # noqa: E402
from test_torch_faults import (B, D, K, N, assert_states_equal,  # noqa: E402
                               ctx, jsession, psession, rewards, tape, uids)

from repro_torch import convert, serve  # noqa: E402
from repro_torch.serve import faults, guardrails  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402


@pytest.fixture(scope="module")
def world():
    e, _ = jenv.make_synthetic_env(jax.random.PRNGKey(0), N, D, 4, K)
    return e, torch.from_numpy(np.array(e.theta))


def test_update_matches_reference_on_a_sample_stream():
    """Random samples (some None, some past their bounds), folded through
    both packages' ``update`` and ``post_rollback_state``: every field
    equal, floats with ``==``."""
    rng = np.random.default_rng(0)
    kw = dict(ctr_floor=0.3, recall_floor=0.9, occupancy_ceiling=0.6,
              latency_ceiling_s=0.02, churn_ceiling=0.2, warmup=40,
              ema=0.8, cooldown=3)
    cfg, jcfg = guardrails.GuardrailConfig(**kw), jguard.GuardrailConfig(**kw)
    gs, jgs = guardrails.GuardrailState(), jguard.GuardrailState()
    n_breaches = 0
    for t in range(400):
        sample = {}
        for name, lo, hi in (("ctr", 0.0, 0.8), ("recall", 0.7, 1.0),
                             ("occupancy", 0.0, 0.9),
                             ("latency_s", 0.0, 0.04), ("churn", 0.0, 0.3),
                             ("tiles_skipped", 0.0, 1.0)):
            if rng.random() < 0.6:
                sample[name] = float(rng.uniform(lo, hi))
        sample["interactions"] = int(rng.integers(0, 16))
        gs = guardrails.update(cfg, gs, **sample)
        jgs = jguard.update(jcfg, jgs, **sample)
        assert dataclasses.asdict(gs) == dataclasses.asdict(jgs), t
        if gs.breaches:
            n_breaches += 1
            gs = guardrails.post_rollback_state(cfg, gs)
            jgs = jguard.post_rollback_state(jcfg, jgs)
            assert dataclasses.asdict(gs) == dataclasses.asdict(jgs)
    assert n_breaches > 10
    assert guardrails.GuardrailConfig().ctr_floor == -math.inf


def test_sign_flip_trips_rolls_back_and_resumes_bit_identical(world,
                                                              tmp_path):
    """Sign-flipped feedback drives the CTR EMA through its floor in both
    packages at the same transaction; the port rolls back to snapshot 0,
    clears the ring with the id counter kept, and replaying the healthy
    inputs gives the healthy choices and state, bit for bit
    (``tests/test_faults.py:341``)."""
    e, theta = world
    kw = dict(ctr_floor=0.05, warmup=2 * B, ema=0.5, snapshot_every=1000,
              cooldown=2)
    g = guardrails.Guarded.create(psession(), CheckpointManager(
        tmp_path / "p", keep=4), guardrails.GuardrailConfig(**kw))
    jg = jguard.Guarded.create(jsession(), JCkpt(tmp_path / "j", keep=4),
                               jguard.GuardrailConfig(**kw))
    healthy = []
    for i in range(40):
        u, c = uids(i), ctx(i)
        g, ch, ids = g.recommend(u, c)
        jg, jch, jids = jg.recommend(jnp.asarray(u.numpy()),
                                     jnp.asarray(c.numpy()))
        np.testing.assert_array_equal(ch.numpy(), np.asarray(jch))
        realized = rewards(theta, i, u, c, ch)[0]
        if i < 6:
            healthy.append((i, ch))
        else:
            realized = -realized
        g = g.observe_delayed(ids, realized)
        jg = jg.observe_delayed(jids, jnp.asarray(realized.numpy()))
        assert g.events == jg.events
        if g.gs.rollbacks:
            break
    assert g.gs.rollbacks == 1 == jg.gs.rollbacks
    rb = [ev for ev in g.events if ev[0] == "rollback"]
    assert rb[0][2] == ("ctr_floor",) and rb[0][3] == 0
    st = serve.pending_stats(g.session)
    assert st["in_flight"] == 0 and st["issued"] > 0
    assert st == jserve.pending_stats(jg.session)

    ref = psession()
    for i, ch_rec in healthy:
        u, c = uids(i), ctx(i)
        g, ch_g, ids_g = g.recommend(u, c)
        ref, ch_r, ids_r = serve.recommend(ref, u, c)
        assert torch.equal(ch_g, ch_rec) and torch.equal(ch_g, ch_r)
        realized = rewards(theta, i, u, c, ch_r)[0]
        g = g.observe_delayed(ids_g, realized)
        ref = serve.observe_delayed(ref, ids_r, realized)
    assert_states_equal(g.session.state, ref.state)


def test_guarded_fault_run_events_match_reference(world, tmp_path):
    """The harness's sign-flip scenario through both packages' guarded
    sessions on the same traffic: the same rollback events, every one on
    the CTR floor."""
    e, theta = world
    spec = faults.FaultSpec(seed=1, p_flip=1.0, flip_after=8)
    kw = dict(ctr_floor=0.2, warmup=2 * B, ema=0.7, snapshot_every=6,
              cooldown=2)
    g = guardrails.Guarded.create(
        psession(capacity=256, ttl=16),
        CheckpointManager(tmp_path / "p", keep=4),
        guardrails.GuardrailConfig(**kw))
    g, rep = faults.run_faulted(
        g, theta, 30, spec, batch=B,
        stream=faults.TrafficStream(2, B, N, device="cpu",
                                    tape=tape(2, 30, B)))
    jg = jguard.Guarded.create(jsession(capacity=256, ttl=16),
                               JCkpt(tmp_path / "j", keep=4),
                               jguard.GuardrailConfig(**kw))
    jg, jrep = jfaults.run_faulted(jg, e.theta, 30, spec, batch=B, key=2)
    rolls = [ev for ev in rep.events if ev[0] == "rollback"]
    assert rolls and all(ev[2] == ("ctr_floor",) for ev in rolls)
    assert rep.events == jrep.events
    assert rep.pending == jrep.pending and rep.reward == jrep.reward
    assert g.gs.rollbacks == len(rolls)


def test_occupancy_trips_on_wedged_feedback(tmp_path):
    """No feedback arrives, the ring fills, and the occupancy ceiling
    trips at ``repro``'s transaction (``tests/test_faults.py:408``)."""
    kw = dict(occupancy_ceiling=0.5, ema=0.5, snapshot_every=1000,
              cooldown=2)
    g = guardrails.Guarded.create(
        psession(capacity=64, ttl=1000),
        CheckpointManager(tmp_path / "p", keep=2),
        guardrails.GuardrailConfig(**kw))
    jg = jguard.Guarded.create(jsession(capacity=64, ttl=1000),
                               JCkpt(tmp_path / "j", keep=2),
                               jguard.GuardrailConfig(**kw))
    for i in range(8):
        g, _, _ = g.recommend(uids(i), ctx(i))
        jg, _, _ = jg.recommend(jnp.asarray(uids(i).numpy()),
                                jnp.asarray(ctx(i).numpy()))
        assert g.gs.ema_occupancy == jg.gs.ema_occupancy
        if g.gs.rollbacks:
            break
    assert g.gs.rollbacks == 1
    assert g.events == jg.events
    assert [ev for ev in g.events if ev[0] == "rollback"][0][2] == (
        "occupancy_ceiling",)


def _catalogs(n_items=96, capacity=128):
    je, _ = jenv.make_catalog_env(jax.random.PRNGKey(5), N, D, 4, n_items,
                                  n_candidates=K)
    jcat = jserve.make_catalog(jenv.catalog_embeddings(je),
                               capacity=capacity)
    pcat = convert.catalog_from_numpy(jax.tree.map(np.asarray, jcat),
                                      device="cpu")
    return je, jcat, pcat


def test_catalog_rollback_restores_state_catalog_and_epoch(tmp_path):
    """A tracked catalog: a small publish is admitted and snapshotted, an
    oversized retirement breaches ``churn_ceiling`` on its raw sample and
    rolls the state AND the catalog back to that snapshot, its epoch
    included; the events are ``repro``'s."""
    je, jcat, pcat = _catalogs()
    theta = torch.from_numpy(np.array(je.theta))
    kw = dict(churn_ceiling=0.25, snapshot_every=2, cooldown=1)
    g = guardrails.Guarded.create(
        psession("distclub", capacity=64, ttl=16),
        CheckpointManager(tmp_path / "p", keep=4),
        guardrails.GuardrailConfig(**kw), catalog=pcat)
    jg = jguard.Guarded.create(jsession("distclub", capacity=64, ttl=16),
                               JCkpt(tmp_path / "j", keep=4),
                               jguard.GuardrailConfig(**kw), catalog=jcat)
    for i in range(3):
        u = uids(i)
        g, items, ids, slots, c = g.recommend_catalog(u, k_short=8)
        jg, jitems, jids, _, _ = jg.recommend_catalog(
            jnp.asarray(u.numpy()), k_short=8)
        np.testing.assert_array_equal(items.numpy(), np.asarray(jitems))
        realized = rewards(theta, i, u, c, slots)[0]
        g = g.observe_delayed(ids, realized)
        jg = jg.observe_delayed(jids, jnp.asarray(realized.numpy()))
        if i == 1:       # a small churn: 4 of 128 slots
            g, slot = g.stage_churn(retire=torch.tensor([0, 1]),
                                    add=torch.eye(D)[:2])
            jg, jslot = jg.stage_churn(retire=jnp.array([0, 1]),
                                       add=jnp.eye(D)[:2])
            np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
            g, jg = g.publish(), jg.publish()
    assert g.events == jg.events and not g.gs.rollbacks
    snap_step = g.last_snapshot
    assert g.catalog.epoch == 1
    saved = g.ckpt.restore(snap_step, {"state": g.session.state,
                                       "catalog": g.catalog})
    # retire 40 of 128 live slots: 0.31 of capacity in one publish
    g, _ = g.stage_churn(retire=torch.arange(2, 42))
    jg, _ = jg.stage_churn(retire=jnp.arange(2, 42))
    g, jg = g.publish(), jg.publish()
    assert g.events == jg.events
    ev = g.events[-1]
    assert ev[0] == "rollback" and ev[2] == ("churn_ceiling",)
    assert ev[3] == snap_step
    assert g.catalog.epoch == saved["catalog"].epoch == 1
    assert g.catalog.active == saved["catalog"].active
    assert_states_equal(g.catalog, saved["catalog"])
    assert_states_equal(g.session.state, saved["state"])
    assert g.catalog.n_live() == jg.catalog.n_live()
    for f in ("emb", "live", "born", "scale"):
        np.testing.assert_array_equal(getattr(g.catalog, f).numpy(),
                                      np.asarray(getattr(jg.catalog, f)))
    assert serve.pending_stats(g.session)["in_flight"] == 0


def test_shortlist_recall_matches_reference_unpruned_and_pruned(tmp_path):
    """``shortlist_recall`` of the served items equals ``repro``'s, on
    healthy serving (1.0, unpruned and pruned, also through
    ``Guarded.step_catalog(probe_recall=True)``) and on items it did not
    serve."""
    je, jcat, pcat = _catalogs(n_items=128, capacity=128)
    theta = torch.from_numpy(np.array(je.theta))
    clusters = serve.build_clusters(pcat, tile_items=16)
    ps = psession("distclub", capacity=0)
    js = jsession("distclub", capacity=0)

    def reward_fn(k, u, c, ch):
        return rewards(theta, k, u, c, ch)

    def jreward(k, u, c, ch):
        return jenv.step_rewards(k, je.theta[u], c, ch)

    g = guardrails.Guarded.create(
        ps, CheckpointManager(tmp_path / "p"),
        guardrails.GuardrailConfig(recall_floor=0.99, warmup=0),
        catalog=pcat)
    for i in range(3):
        u = uids(i)
        pre = ps
        ps, items, _ = serve.step_catalog(ps, i, u, pcat, reward_fn,
                                          k_short=8)
        _, pitems, _, _ = serve.step_catalog(pre, i, u, pcat, reward_fn,
                                             k_short=8, clusters=clusters)
        js2, jitems, _ = jserve.step_catalog(js, jax.random.PRNGKey(i),
                                             jnp.asarray(u.numpy()), jcat,
                                             jreward, k_short=8)
        assert torch.equal(items, pitems)
        np.testing.assert_array_equal(items.numpy(), np.asarray(jitems))
        bad = torch.where(torch.arange(B) % 3 == 0, 127 - items, items)
        for served in (items, bad):
            got = guardrails.shortlist_recall(pre, pcat, u, served,
                                              k_short=8)
            want = jguard.shortlist_recall(js, jcat, jnp.asarray(u.numpy()),
                                           jnp.asarray(served.numpy()),
                                           k_short=8)
            assert got == want
        assert guardrails.shortlist_recall(pre, pcat, u, items,
                                           k_short=8) == 1.0
        js = js2
        g, gitems, _, rmet = g.step_catalog(i, u, reward_fn=reward_fn,
                                            k_short=8, probe_recall=True,
                                            clusters=clusters)
        assert torch.equal(gitems, items) and rmet.pruned_active == 1
    assert g.gs.ema_recall == 1.0 and not g.gs.rollbacks
    assert g.gs.ema_tiles_skipped is not None


def test_int8_shortlist_recall_after_churn_matches_dequantized_reference():
    """The port departs from ``repro`` here: on an int8 bank the port's
    oracle shortlist scores the dequantized rows (the per-slot scales
    passed in, as the serving shortlist does), where ``repro``'s ranks the
    raw codes.  After churn that gave the bank distinct row scales, the
    port's recall of healthy serving is ``repro``'s ``shortlist_recall``
    on an f32 catalog of the dequantized rows, 1.0 in every batch;
    ``repro``'s on the int8 bank itself falls below 1.0."""
    je, _ = jenv.make_catalog_env(jax.random.PRNGKey(5), N, D, 4, 96,
                                  n_candidates=K)
    theta = torch.from_numpy(np.array(je.theta))
    jcat = jserve.make_catalog(jenv.catalog_embeddings(je), capacity=128,
                               precision="int8")
    pcat = convert.catalog_from_numpy(jax.tree.map(np.asarray, jcat),
                                      device="cpu")
    g = torch.Generator().manual_seed(11)
    pcat, _ = serve.retire_items(pcat, torch.randperm(96, generator=g)[:48])
    add = torch.randn(32, D, generator=g) * torch.linspace(0.5, 2.0, 32)[
        :, None]
    pcat, slots, n_added = serve.add_items(pcat, add)
    pcat = serve.publish(pcat)
    assert n_added == 32
    live = pcat.serving.live > 0
    assert len(torch.unique(pcat.serving.scale[live])) > 32
    # the same catalog for repro: its int8 codes, and f32 dequantized rows
    jint8 = jserve.Catalog(*(jnp.asarray(np.asarray(v)) for v in pcat))
    deq = torch.stack([serve.dequantize(pcat._bank(b)) for b in (0, 1)])
    jf32 = jint8._replace(emb=jnp.asarray(deq.numpy()),
                          scale=jnp.ones_like(jint8.scale))

    def reward_fn(k, u, c, ch):
        return rewards(theta, k, u, c, ch)

    sess = psession("distclub", capacity=0)
    js = jsession("distclub", capacity=0)
    repro_int8 = []
    for i in range(12):
        u = uids(i)
        pre = sess
        sess, items, _ = serve.step_catalog(sess, i, u, pcat, reward_fn,
                                            k_short=8)
        st = convert.record_to_numpy(pre.state)
        jpre = dataclasses.replace(js, state=type(js.state)(
            *(jnp.asarray(v) for v in st)))
        ju, jitems = jnp.asarray(u.numpy()), jnp.asarray(items.numpy())
        got = guardrails.shortlist_recall(pre, pcat, u, items, k_short=8)
        want = jguard.shortlist_recall(jpre, jf32, ju, jitems, k_short=8)
        assert got == want == 1.0, i
        repro_int8.append(jguard.shortlist_recall(jpre, jint8, ju, jitems,
                                                  k_short=8))
    assert min(repro_int8) < 1.0
