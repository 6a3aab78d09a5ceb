"""The port's online experiments (``repro_torch.serve.experiments``)
against ``repro.serve.experiments`` on the CPU, at
``tests/test_experiments.py``'s sizes, on the same traffic (``repro``'s
draws replayed through a ``faults.Tape``): the sticky hash bit for bit,
arm assignments under shrinking fractions, disabled arms and probation
scales, single-arm parity with the plain session on the synchronous and
split paths, multi-arm routing against masked sub-sessions, a checkpoint
round trip, the poisoned-arm disable, the probation life cycle, the
selector's re-weighting and posteriors, and the report.  Choices, ids,
shares, events and counters are equal; LinUCB statistics within 1e-5.
Also pins down that the port's sessions never write their input state,
which the in-memory per-arm rollback snapshots rely on."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import serve as jserve  # noqa: E402
from repro.core import env as jenv  # noqa: E402
from repro.serve import experiments as jexp  # noqa: E402
from repro.serve import guardrails as jguard  # noqa: E402
from test_torch_faults import (B, D, JHYPER, K, N, PHYPER,  # noqa: E402
                               POLICIES, assert_close_to_reference,
                               assert_states_equal, draws, tape)

from repro_torch import serve  # noqa: E402
from repro_torch.core import env  # noqa: E402
from repro_torch.serve import experiments, faults, guardrails  # noqa: E402
from repro_torch.train.checkpoint import CheckpointManager  # noqa: E402


def jsess(policy="linucb", alpha=0.03, capacity=128, ttl=16):
    return jserve.OnlineBandit.create(
        N, D, JHYPER._replace(alpha=alpha), policy=policy, refresh_every=N,
        pending_capacity=capacity, pending_ttl=ttl, backend="reference")


def psess(policy="linucb", alpha=0.03, capacity=128, ttl=16):
    return serve.OnlineBandit.create(
        N, D, PHYPER._replace(alpha=alpha), policy=policy, refresh_every=N,
        pending_capacity=capacity, pending_ttl=ttl, device="cpu")


@pytest.fixture(scope="module")
def world():
    e, _ = jenv.make_synthetic_env(jax.random.PRNGKey(0), N, D, 4, K)
    return e, torch.from_numpy(np.array(e.theta))


def uids(i, n=B, lo=-2):
    """Request users with negative padding rows (``lo`` < 0)."""
    return torch.from_numpy(np.array(jax.random.randint(
        jax.random.PRNGKey(1000 + i), (n,), lo, N)))


def ctx(i, n=B):
    c = jax.random.normal(jax.random.PRNGKey(2000 + i), (n, K, D))
    return torch.from_numpy(np.array(c / jnp.sqrt(jnp.float32(D))))


def J(t):
    return jnp.asarray(t.numpy())


def rewards(theta, key, u, c, ch):
    th = theta[u.clamp(0, N - 1).long()]
    return env.step_rewards(draws(key, u.shape[0]), th, c, ch)


# ---------------------------------------------------------------------------
# sticky assignment
# ---------------------------------------------------------------------------


def test_hash01_is_bit_equal_to_reference():
    """Every id of [-2, 2^20) and a sample of large ids and salts."""
    ids = np.arange(-2, 1 << 20, dtype=np.int32)
    for salt in (0, 9, 0xFFFFFFFF):
        got = experiments._hash01(torch.from_numpy(ids), salt).numpy()
        want = np.asarray(jexp._hash01(jnp.asarray(ids), salt))
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(1)
    big = rng.integers(-2**31, 2**31, 4096).astype(np.int32)
    for salt in rng.integers(0, 2**32, 16):
        np.testing.assert_array_equal(
            experiments._hash01(torch.from_numpy(big), int(salt)).numpy(),
            np.asarray(jexp._hash01(jnp.asarray(big), int(salt))))


ASSIGN_CASES = [
    ((0.5, 0.5), (True, True), 9, None),
    ((0.3, 0.7), (True, True), 5, None),
    ((0.2, 0.5, 0.3), (True,) * 3, 5, None),
    ((0.4, 0.3, 0.3), (True, False, True), 2, None),
    ((0.4, 0.3, 0.3), (True,) * 3, 2, (1.0, 0.25, 1.0)),
    ((0.4, 0.3, 0.3), (True,) * 3, 2, (0.5, 0.25, 0.5)),
    ((0.13867188, 0.86132812, 0.0), (True, True, False), 7, None),
    ((1.0, 0.0), (True, True), 6, None),
]


@pytest.mark.parametrize("fractions,enabled,salt,scale", ASSIGN_CASES)
def test_assign_arms_equals_reference(fractions, enabled, salt, scale):
    uids_ = np.arange(-4, 4096, dtype=np.int32)
    got = experiments.assign_arms(torch.from_numpy(uids_), fractions,
                                  enabled, salt=salt, scale=scale).numpy()
    want = np.asarray(jexp.assign_arms(jnp.asarray(uids_), fractions,
                                       enabled, salt=salt, scale=scale))
    np.testing.assert_array_equal(got, want)
    assert (got[:4] == -1).all()
    assert not any((got == a).any() for a, e in enumerate(enabled) if not e)


def test_shrink_and_disable_move_only_leavers():
    """Shrinking arm 0 moves only its leavers; disabling arm 1 moves only
    its users; a probation scale takes back a strict subset."""
    u = torch.arange(4 * N)
    before = experiments.assign_arms(u, (0.5, 0.5), (True, True), salt=5)
    after = experiments.assign_arms(u, (0.3, 0.7), (True, True), salt=5)
    moved = before != after
    assert moved.any() and (before[moved] == 0).all()
    assert (after[moved] == 1).all()
    f = (0.4, 0.3, 0.3)
    full = experiments.assign_arms(u, f, (True,) * 3, salt=2)
    dis = experiments.assign_arms(u, f, (True, False, True), salt=2)
    prob = experiments.assign_arms(u, f, (True,) * 3, salt=2,
                                   scale=(1.0, 0.25, 1.0))
    keep = full != 1
    assert torch.equal(full[keep], dis[keep])
    assert torch.equal(full[keep], prob[keep])
    back = prob == 1
    assert back.any() and back.sum() < (full == 1).sum()


# ---------------------------------------------------------------------------
# single-arm parity and routing
# ---------------------------------------------------------------------------


def _feedback_loop(exp, plain, theta, rounds, jplain=None):
    for i in range(rounds):
        u, c = uids(i), ctx(i)
        exp, c_e, ids_e = experiments.recommend(exp, u, c)
        plain, c_p, ids_p = serve.recommend(plain, u, c)
        assert torch.equal(c_e, c_p) and torch.equal(ids_e, ids_p)
        r = rewards(theta, jax.random.PRNGKey(3000 + i), u, c, c_p)[0]
        exp = experiments.observe_delayed(exp, ids_e, r)
        plain = serve.observe_delayed(plain, ids_p, r)
        if jplain is not None:
            jplain, jc, jids = jserve.recommend(jplain, J(u), J(c))
            np.testing.assert_array_equal(c_p.numpy(), np.asarray(jc))
            np.testing.assert_array_equal(ids_p.numpy(), np.asarray(jids))
            jplain = jserve.observe_delayed(jplain, jids, J(r))
    return exp, plain, jplain


def test_single_arm_parity_with_plain_session(world):
    """One arm at fraction 1.0 is the plain buffered session: choices,
    decision ids, state and ring, and the plain session is ``repro``'s."""
    _, theta = world
    exp, plain, jplain = _feedback_loop(
        experiments.create([psess()]), psess(), theta, 5, jsess())
    assert_states_equal(exp.arms[0].state, plain.state)
    assert_states_equal(exp.arms[0].pending, plain.pending)
    assert_close_to_reference(plain.state, jplain.state)


def test_single_arm_parity_sync_step(world):
    _, theta = world

    def reward_fn(key, u, c, ch):
        return rewards(theta, jax.random.PRNGKey(key), u, c, ch)

    exp = experiments.create([psess(capacity=0)])
    plain = psess(capacity=0)
    for i in range(4):
        u, c = uids(i), ctx(i)
        exp, c_e, m = experiments.step(exp, i, u, c, reward_fn)
        plain, c_p, mp = serve.step(plain, i, u, c, reward_fn)
        assert torch.equal(c_e, c_p) and float(m[0].reward) == float(
            mp.reward)
    assert_states_equal(exp.arms[0].state, plain.state)
    assert exp.totals["interactions"][0] == int(exp.counts.sum())


def test_fraction_one_masked_path_parity(world):
    """fractions (1.0, 0.0) go through the masked multi-arm router and
    stay bit-identical to the plain session; ids are ``local * 2``."""
    _, theta = world
    exp = experiments.create([psess(), psess(alpha=1.0)],
                             fractions=(1.0, 0.0), salt=6)
    plain = psess()
    for i in range(4):
        u, c = uids(i), ctx(i)
        exp, c_e, ids_e = experiments.recommend(exp, u, c)
        plain, c_p, ids_p = serve.recommend(plain, u, c)
        assert torch.equal(c_e, c_p)
        assert torch.equal(ids_e, torch.where(ids_p >= 0, ids_p * 2, -1))
        r = rewards(theta, jax.random.PRNGKey(3000 + i), u, c, c_p)[0]
        exp = experiments.observe_delayed(exp, ids_e, r)
        plain = serve.observe_delayed(plain, ids_p, r)
    assert_states_equal(exp.arms[0].state, plain.state)
    assert_states_equal(exp.arms[1].state, psess(alpha=1.0).state)


def test_multi_arm_routing_matches_reference_and_sub_sessions(world):
    """Each arm evolves exactly as a standalone session fed the masked
    sub-batches, and the routed choices and arm-encoded ids are
    ``repro``'s."""
    _, theta = world
    exp = experiments.create([psess(alpha=0.03), psess(alpha=1.0)], salt=7)
    jx = jexp.create([jsess(alpha=0.03), jsess(alpha=1.0)], salt=7)
    solo = [psess(alpha=0.03), psess(alpha=1.0)]
    for i in range(4):
        u, c = uids(i), ctx(i)
        arm_of = experiments.assign_arms(exp, u)
        exp, c_e, ids_e = experiments.recommend(exp, u, c)
        jx, jc, jids = jexp.recommend(jx, J(u), J(c))
        np.testing.assert_array_equal(c_e.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ids_e.numpy(), np.asarray(jids))
        r = rewards(theta, jax.random.PRNGKey(3000 + i), u, c, c_e)[0]
        for a in range(2):
            solo[a], c_s, ids_s = serve.recommend(
                solo[a], torch.where(arm_of == a, u, -1), c)
            mine = arm_of == a
            assert torch.equal(c_e[mine], c_s[mine])
            assert torch.equal(ids_e[mine], ids_s[mine] * 2 + a)
            solo[a] = serve.observe_delayed(solo[a], ids_s, r)
        exp = experiments.observe_delayed(exp, ids_e, r)
        jx = jexp.observe_delayed(jx, jids, J(r))
    for a in range(2):
        assert_states_equal(exp.arms[a].state, solo[a].state)
        assert_close_to_reference(exp.arms[a].state, jx.arms[a].state)


# ---------------------------------------------------------------------------
# the harness, checkpoints and the report
# ---------------------------------------------------------------------------


def _stream(key, rounds):
    return faults.TrafficStream(key, B, N, device="cpu",
                                tape=tape(key, rounds, B))


def _report_equal(p, j):
    for f in ("rounds", "names", "enabled", "fractions", "reward",
              "interactions", "delivered", "matched_ratio", "shares",
              "leader", "runner_up", "events"):
        assert getattr(p, f) == getattr(j, f), f
    for f in ("expected", "best", "rand_reward", "regret"):
        np.testing.assert_allclose(getattr(p, f), getattr(j, f), rtol=1e-5,
                                   err_msg=f)
    np.testing.assert_allclose(p.z_leading_pair, j.z_leading_pair,
                               rtol=1e-9)


def test_checkpoint_round_trip_resumes_identical_routing(world, tmp_path):
    e, theta = world

    def mk():
        return experiments.create(
            [psess(alpha=0.03), psess(alpha=1.0)], salt=13,
            selector=experiments.make_selector(2, epoch_rounds=3))

    ck = CheckpointManager(tmp_path / "exp", keep=2)
    exp, _ = experiments.run_experiment(mk(), theta, 7, batch=B,
                                        stream=_stream(5, 7))
    experiments.save(exp, ck, 7)
    cont, rep = experiments.run_experiment(exp, theta, 6, batch=B,
                                           stream=_stream(99, 6))
    fresh, step = experiments.restore(mk(), ck, 7)
    assert step == 7 and fresh.steps == exp.steps
    assert fresh.fractions == exp.fractions
    u = torch.arange(N)
    assert torch.equal(experiments.assign_arms(exp, u),
                       experiments.assign_arms(fresh, u))
    cont2, rep2 = experiments.run_experiment(fresh, theta, 6, batch=B,
                                             stream=_stream(99, 6))
    for a in range(2):
        assert_states_equal(cont.arms[a].state, cont2.arms[a].state)
    np.testing.assert_array_equal(cont.totals["reward"],
                                  cont2.totals["reward"])
    assert cont.fractions == cont2.fractions

    # the same two legs in repro
    jx, _ = jexp.run_experiment(
        jexp.create([jsess(alpha=0.03), jsess(alpha=1.0)], salt=13,
                    selector=jexp.make_selector(2, epoch_rounds=3)),
        e.theta, 7, batch=B, key=5)
    jx, jrep = jexp.run_experiment(jx, e.theta, 6, batch=B, key=99)
    assert cont.fractions == jx.fractions
    np.testing.assert_array_equal(cont.selector.alpha, jx.selector.alpha)
    np.testing.assert_array_equal(cont.counts, jx.counts)
    for a in range(2):
        assert_close_to_reference(cont.arms[a].state, jx.arms[a].state)


def test_restore_empty_dir_is_noop(tmp_path):
    exp = experiments.create([psess()])
    same, step = experiments.restore(
        exp, CheckpointManager(tmp_path / "none"), None)
    assert step is None and same is exp


def _poisoned_loop(exp, jx, theta, rounds, flip_arm, start=0):
    """Arm ``flip_arm``'s delivered rewards sign-flipped, in both
    packages (``tests/test_experiments.py``'s loop)."""
    A = exp.n_arms
    for i in range(start, start + rounds):
        u = torch.from_numpy(np.array(jax.random.randint(
            jax.random.PRNGKey(100 + i), (B,), 0, N)))
        c = ctx(i)
        exp, ch, ids = experiments.recommend(exp, u, c)
        jx, jch, jids = jexp.recommend(jx, J(u), J(c))
        np.testing.assert_array_equal(ch.numpy(), np.asarray(jch))
        np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
        r = rewards(theta, jax.random.PRNGKey(300 + i), u, c, ch)[0]
        arm_of = torch.where(ids >= 0, ids % A, -1)
        r = torch.where(arm_of == flip_arm, -r, r)
        exp = experiments.observe_delayed(exp, ids, r)
        jx = jexp.observe_delayed(jx, jids, J(r))
        assert exp.events == jx.events and exp.enabled == jx.enabled
    return exp, jx


def test_poisoned_arm_auto_disabled_and_rerouted(world):
    _, theta = world
    kw = dict(ctr_floor=0.2, warmup=2 * B, ema=0.6, cooldown=2)
    exp = experiments.create([psess(), psess()], salt=3, snapshot_every=2,
                             guard_cfg=guardrails.GuardrailConfig(**kw))
    jx = jexp.create([jsess(), jsess()], salt=3, snapshot_every=2,
                     guard_cfg=jguard.GuardrailConfig(**kw))
    exp, jx = _poisoned_loop(exp, jx, theta, 12, flip_arm=1)
    assert exp.enabled == (True, False)
    assert "disable" in [ev[0] for ev in exp.events]
    assert (experiments.assign_arms(exp, torch.arange(N)) == 0).all()
    assert int(exp.arms[1].pending.uid.max()) < 0
    assert exp.guards[1].rollbacks == 1
    for a in range(2):
        assert_close_to_reference(exp.arms[a].state, jx.arms[a].state)


def test_last_enabled_arm_is_never_disabled(world):
    _, theta = world
    kw = dict(ctr_floor=0.2, warmup=B, ema=0.6, cooldown=1)
    exp = experiments.create([psess()],
                             guard_cfg=guardrails.GuardrailConfig(**kw))
    jx = jexp.create([jsess()], guard_cfg=jguard.GuardrailConfig(**kw))
    exp, _ = _poisoned_loop(exp, jx, theta, 8, flip_arm=0)
    assert exp.enabled == (True,)
    assert any(ev[0] == "breach-last-arm" for ev in exp.events)


@pytest.mark.parametrize("probation_tx,fraction,rounds", [(3, 0.25, 20),
                                                          (2, 0.5, 40)])
def test_probation_life_cycle_matches_reference(world, probation_tx,
                                                fraction, rounds):
    """Bench -> throttled probation -> restore (a clean window), and a
    second breach on probation that disables for good: the stages,
    events and assignments are ``repro``'s at every transaction."""
    _, theta = world
    kw = dict(ctr_floor=0.2, warmup=2 * B if probation_tx == 3 else B,
              ema=0.6, cooldown=2 if probation_tx == 3 else 1)
    exp = experiments.create(
        [psess(), psess()], salt=3, snapshot_every=2,
        guard_cfg=guardrails.GuardrailConfig(**kw),
        probation_tx=probation_tx, probation_fraction=fraction)
    jx = jexp.create([jsess(), jsess()], salt=3, snapshot_every=2,
                     guard_cfg=jguard.GuardrailConfig(**kw),
                     probation_tx=probation_tx,
                     probation_fraction=fraction)
    u = torch.arange(N)
    i = 0
    if probation_tx == 3:
        while exp.enabled == (True, True) and i < 20:
            exp, jx = _poisoned_loop(exp, jx, theta, 1, 1, start=i)
            i += 1
        assert exp.stages[1] == experiments.BENCHED
        exp, jx = _poisoned_loop(exp, jx, theta, 3, -1, start=i)
        assert exp.stages[1] == experiments.PROBATION
        back = experiments.assign_arms(exp, u) == 1
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jexp.assign_arms(jx, J(u))) == 1)
        assert back.any()
        exp, jx = _poisoned_loop(exp, jx, theta, 3, -1, start=i + 3)
        assert exp.stages[1] == experiments.HEALTHY
        assert any(ev[0] == "restore" for ev in exp.events)
    else:
        exp, jx = _poisoned_loop(exp, jx, theta, rounds, 1)
        assert exp.stages[1] == experiments.PERMANENT
        assert any(ev[0] == "disable-permanent" for ev in exp.events)
        exp, jx = _poisoned_loop(exp, jx, theta, 6, -1, start=rounds)
        assert exp.enabled == (True, False)
    assert exp.stages == jx.stages and exp.events == jx.events


def test_selector_reweight_and_posteriors_match_reference(world):
    """``_reweight`` on the same posteriors, and the bucketed selector
    through a run: alpha, beta and the shares over time are
    ``repro``'s."""
    e, theta = world
    rng = np.random.default_rng(2)
    for en in ((True, True, True), (True, False, True)):
        sel = experiments.make_selector(3, floor=0.05)._replace(
            alpha=rng.uniform(1, 40, (2, 3)), beta=rng.uniform(1, 40, (2, 3)))
        jsel = jexp.make_selector(3, floor=0.05)._replace(
            alpha=sel.alpha, beta=sel.beta)
        for epoch in range(3):
            assert experiments._reweight(sel, en, 11, epoch) == \
                jexp._reweight(jsel, en, 11, epoch)
    exp = experiments.create(
        [psess(), psess(alpha=1.0)], salt=1,
        selector=experiments.make_selector(2, epoch_rounds=5,
                                           bucket_edges=(3, 21)))
    exp, rep = experiments.run_experiment(exp, theta, 10, batch=B,
                                          stream=_stream(2, 10))
    jx, jrep = jexp.run_experiment(
        jexp.create([jsess(), jsess(alpha=1.0)], salt=1,
                    selector=jexp.make_selector(2, epoch_rounds=5,
                                                bucket_edges=(3, 21))),
        e.theta, 10, batch=B, key=2)
    assert exp.selector.alpha.shape == (3, 2)
    np.testing.assert_array_equal(exp.selector.alpha, jx.selector.alpha)
    np.testing.assert_array_equal(exp.selector.beta, jx.selector.beta)
    assert rep.shares == jrep.shares and len(rep.shares) == 3


def test_report_and_selector_run_match_reference(world):
    """Three arms under the selector and delivery faults: the report is
    ``repro``'s, the tuned arm leads, every enabled arm keeps its floor,
    and fractions move only at epoch boundaries."""
    e, theta = world
    spec = faults.FaultSpec(seed=3, p_delay=0.3, p_loss=0.05, p_dup=0.05)
    names = ("good", "noisy1", "noisy2")
    exp = experiments.create(
        [psess(alpha=0.05), psess(alpha=50.0), psess(alpha=50.0)],
        names=names, salt=11,
        selector=experiments.make_selector(3, epoch_rounds=10, floor=0.05))
    exp, rep = experiments.run_experiment(exp, theta, 40, spec=spec,
                                          batch=B, stream=_stream(5, 40))
    jx, jrep = jexp.run_experiment(
        jexp.create([jsess(alpha=0.05), jsess(alpha=50.0),
                     jsess(alpha=50.0)], names=names, salt=11,
                    selector=jexp.make_selector(3, epoch_rounds=10,
                                                floor=0.05)),
        e.theta, 40, spec=spec, batch=B, key=5)
    _report_equal(rep, jrep)
    assert rep.leader == "good" and all(f > 0 for f in rep.fractions)
    assert [s % 10 for s, _ in rep.shares] == [0] * len(rep.shares)
    assert rep.regret == tuple(b - x for b, x in zip(rep.best,
                                                     rep.expected))
    assert np.isfinite(rep.z_leading_pair)


# ---------------------------------------------------------------------------
# the sessions are functional: the rollback snapshots rely on it
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", POLICIES)
def test_sessions_never_write_their_input_state(world, policy):
    """A kept reference to a session's state is unchanged after a step, a
    delayed fold (issue and match) and a refresh from it."""
    _, theta = world
    s = psess(policy, alpha=0.3)
    for i in range(2):          # some statistics and a refresh first
        s, _, _ = serve.step(
            s, i, uids(i, lo=0), ctx(i),
            lambda k, u, c, ch: rewards(theta, jax.random.PRNGKey(k), u, c,
                                        ch))
    kept = s
    copies = [t.clone() if isinstance(t, torch.Tensor) else t
              for t in _leaves(s.state)]
    ring = [t.clone() for t in s.pending]
    u, c = uids(5, lo=0), ctx(5)
    s1, _, _ = serve.step(kept, 5, u, c, lambda k, u, c, ch: rewards(
        theta, jax.random.PRNGKey(k), u, c, ch))
    s2, ch, ids = serve.recommend(kept, u, c)
    s2 = serve.observe_delayed(s2, ids, torch.ones(B))
    s3 = serve.refresh(kept)
    for got, want in zip(_leaves(kept.state), copies):
        assert (torch.equal(got, want) if isinstance(got, torch.Tensor)
                else got == want)
    for got, want in zip(kept.pending, ring):
        assert torch.equal(got, want)
    assert not torch.equal(s1.policy.occ_of(s1.state),
                           kept.policy.occ_of(kept.state))
    del s2, s3


def _leaves(record):
    for v in record:
        if hasattr(v, "_fields"):
            yield from _leaves(v)
        else:
            yield v


# ---------------------------------------------------------------------------
# the CLI and the example on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [
    ["--selector", "--guard", "--faults", "--flip", "1.0", "--flip-after",
     "6", "--epoch-rounds", "5"],
    ["--env", "drift", "--selector", "--buckets", "--epoch-rounds", "5"],
    ["--env", "catalog", "--items", "64", "--k-short", "8"]])
def test_abrun_cli_prints_the_reference_report(extra, capsys):
    from repro_torch.launch import abrun
    exp, rep = abrun.main(["--device", "cpu", "--users", "32", "--d", "8",
                           "--batch", "8", "--capacity", "64", "--rounds",
                           "12"] + extra)
    out = capsys.readouterr().out
    for label in ("[experiment] 12 rounds, final split", "reward",
                  "regret", "decisions", "matched", "leader:", "z = "):
        assert label in out, (label, out)
    assert rep.names == ("distclub", "dccb", "linucb")
    assert sum(rep.interactions) > 0
    if "--selector" in extra:
        assert "shares over time:" in out and len(rep.shares) == 3
    if "--guard" in extra:
        assert any(ev[0] == "disable" for ev in rep.events)
        assert "event: ('disable'" in out


def test_ab_experiment_example_disables_the_poisoned_arm(capsys):
    import importlib
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                           / "examples"))
    try:
        example = importlib.import_module("ab_experiment_torch")
    finally:
        sys.path.pop(0)
    exp, rep = example.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert exp.enabled == (True, True, False)
    assert "<- DISABLED" in out and "experiment still live" in out
    assert rep.events[0][:3] == ("disable", rep.events[0][1], "linucb")
