"""The PyTorch port's DistCLUB epoch against ``repro.core.distclub`` on
the CPU: the same draws (a tape replaying the reference's JAX key
schedule) through both packages, from the same start or from a state
handed across with ``repro_torch.convert``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import backend as jbackend  # noqa: E402
from repro.core import distclub as jdistclub  # noqa: E402
from repro.core import env as jenv  # noqa: E402
from repro.core import env_ops as jenv_ops  # noqa: E402
from repro.core.types import BanditHyper as JHyper  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import distclub, env, env_ops  # noqa: E402
from repro_torch.core.types import BanditHyper  # noqa: E402

N_EPOCHS = 2
RUN_KEY = 1
HYPER = dict(sigma=4, max_rounds=8, gamma=0.6)


def _tape(n, K, d, R, n_epochs, key):
    """Replay the reference's key schedule: epoch split (distclub.py:229),
    k1, k3 (distclub.py:218), per-round split (stages.py:112) and
    k_ctx, k_rew (stages.py:95); contexts from ``_unit_contexts`` and the
    Bernoulli uniforms from the per-user keys, as ``_bernoulli_metrics``."""

    @jax.jit
    def draws(k):
        k_ctx, k_rew = jax.random.split(k)
        ctx = jenv_ops._unit_contexts(k_ctx, n, K, d, 0)
        keys = jenv_ops._user_keys(k_rew, n, 0)
        u = jax.vmap(lambda kk: jax.random.uniform(kk, ()))(keys)
        return ctx, u

    ctx, uni = [], []
    for ke in jax.random.split(key, n_epochs):
        for ks in jax.random.split(ke):
            for k in jax.random.split(ks, R):
                c, u = draws(k)
                ctx.append(np.asarray(c))
                uni.append(np.asarray(u))
    return np.stack(ctx), np.stack(uni)


def _setup(n, d, K, n_clusters=3):
    jhyper = JHyper(n_candidates=K, **HYPER)
    e, _ = jenv.make_synthetic_env(jax.random.PRNGKey(0), n, d, n_clusters,
                                   K, within_cluster_noise=0.05)
    ctx, uni = _tape(n, K, d, jhyper.max_rounds, N_EPOCHS,
                     jax.random.PRNGKey(RUN_KEY))
    tape = env_ops.tape_ops(torch.from_numpy(np.array(e.theta)),
                            torch.from_numpy(ctx), torch.from_numpy(uni))
    cfg = jbackend.BackendConfig.create("reference")
    engines = dict(backend=cfg.interact(n, d, K), graph=cfg.graph(n))
    return jhyper, jenv_ops.synthetic_ops(e), tape, engines


def _assert_states_match(port, ref):
    """Exact where the reference is exact; f32 tolerances elsewhere."""
    p = convert.state_to_numpy(port)
    np.testing.assert_array_equal(p.graph.labels, np.asarray(ref.graph.labels))
    np.testing.assert_array_equal(p.graph.adj, np.asarray(ref.graph.adj))
    np.testing.assert_array_equal(p.lin.occ, np.asarray(ref.lin.occ))
    np.testing.assert_array_equal(p.u_rounds, np.asarray(ref.u_rounds))
    np.testing.assert_array_equal(p.c_rounds, np.asarray(ref.c_rounds))
    np.testing.assert_array_equal(p.comm_bytes, np.asarray(ref.comm_bytes))
    # Sherman-Morrison state: the reference's own kernel-vs-oracle tolerance
    np.testing.assert_allclose(p.lin.Minv, np.asarray(ref.lin.Minv), atol=1e-5)
    np.testing.assert_allclose(p.lin.b, np.asarray(ref.lin.b), atol=1e-5)
    # M = inv(Minv) amplifies the Minv error by the Gram's conditioning
    np.testing.assert_allclose(p.lin.M, np.asarray(ref.lin.M), rtol=1e-5,
                               atol=1e-4)


def _assert_metrics_match(m, jm):
    # same choices => same Bernoulli draws: rewards are exact integers
    np.testing.assert_array_equal(m.reward.numpy(), np.asarray(jm.reward))
    np.testing.assert_array_equal(m.interactions.numpy(),
                                  np.asarray(jm.interactions))


@pytest.mark.parametrize("n,d,K", [(37, 5, 10), (64, 8, 20)])
def test_run_matches_reference_on_tape(n, d, K):
    jhyper, jops, tape, engines = _setup(n, d, K)
    js, jm, jc = jdistclub.run(jops, jax.random.PRNGKey(RUN_KEY), jhyper,
                               n_epochs=N_EPOCHS, d=d, **engines)
    s, m, c = distclub.run(tape, 0, BanditHyper(*jhyper), N_EPOCHS, d,
                           device="cpu")
    assert m.reward.shape == (N_EPOCHS * 2 * jhyper.max_rounds,)
    _assert_metrics_match(m, jm)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    _assert_states_match(s, js)


def test_state_carried_across_matches_reference():
    """Epoch 1 in the reference, handed to the port, epoch 2 in both."""
    n, d, K = 37, 5, 10
    jhyper, jops, tape, engines = _setup(n, d, K)
    hyper = BanditHyper(*jhyper)
    k_epochs = jax.random.split(jax.random.PRNGKey(RUN_KEY), N_EPOCHS)

    def jax_epoch(state, k):
        k1, k3 = jax.random.split(k)
        state, m1 = jdistclub.stage1(state, jops, k1, jhyper,
                                     engines["backend"])
        state = jdistclub.stage2(state, jhyper, d, engines["graph"])
        n_clu = int(jnp.sum(state.graph.labels == jnp.arange(n)))
        state, m3 = jdistclub.stage3(state, jops, k3, jhyper,
                                     engines["backend"])
        state = jdistclub.stage4(state, jhyper)
        return state, jax.tree.map(lambda a, b: jnp.concatenate([a, b]),
                                   m1, m3), n_clu

    jstate, _, _ = jax_epoch(jdistclub.init_state(n, d, jhyper), k_epochs[0])
    state = convert.state_from_numpy(jax.tree.map(np.asarray, jstate),
                                     device="cpu")
    _assert_states_match(state, jstate)

    jstate, jm, jn = jax_epoch(jstate, k_epochs[1])
    state, m, n_clu = distclub.epoch(state, tape, 0, 1, hyper, d)
    _assert_metrics_match(m, jm)
    assert int(n_clu) == jn
    _assert_states_match(distclub.refresh_gram(state),
                         jdistclub.refresh_gram(jstate))


def test_stages_leave_the_callers_state_alone():
    """The engine updates Minv and b in place on both devices; the rounds
    must work on private copies, so a state handed to a stage is not
    changed by it."""
    n, d, K = 24, 4, 6
    hyper = BanditHyper(n_candidates=K, **HYPER)
    e, _ = env.make_synthetic_env(0, n, d, 3, K, 0.05, device="cpu")
    ops = env_ops.synthetic_ops(e)
    state = distclub.init_state(n, d, hyper, device="cpu")
    before = [t.clone() for t in (state.lin.Minv, state.lin.b)]
    s1, _ = distclub.stage1(state, ops, 0, 0, hyper)
    for t, t0 in zip((state.lin.Minv, state.lin.b), before):
        assert torch.equal(t, t0)
    s2 = distclub.stage2(s1, hyper, d)
    before = [t.clone() for t in (s2.lin.Minv, s2.lin.b)]
    s3, _ = distclub.stage3(s2, ops, 0, hyper.max_rounds, hyper)
    for t, t0 in zip((s2.lin.Minv, s2.lin.b), before):
        assert torch.equal(t, t0)
    # and the rounds did update the copies
    assert not torch.equal(s1.lin.Minv, state.lin.Minv)
    assert not torch.equal(s3.lin.Minv, s2.lin.Minv)
